"""The port's Adam tracker and its async sync mode, on the CPU.

- ``tracking_loss`` and its gradient with respect to the camera tensor, and
  ``track_frame(method="adam")`` with the JAX draws replayed, against the
  JAX package on identical parameters (carried across with convert.py).
  Tolerances: 1e-5 on values and 2e-5 on gradients (relative to the largest
  entry); the Adam solve 1e-4 on the pose, as the GN solve's test.
- Async sync against strict on the same seed: the same trajectory and map,
  bit for bit (the sync method changes when the host waits, not the math).
- The whole-event rollback of a faulty async mapping event under BA: the
  state after the rollback equals the state before the event bit for bit.
- Which kernels the Adam tracker's backward asks for: K2 without the grid
  gradient, and no K5 on the packed route.
- The sync-free cumulative product of the compositing step against
  ``torch.cumprod``, bit for bit, and the keyframe DB's one-event snapshot.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.core.pose import tensor_from_camera as jtensor_from_camera
from niceslam_tpu.core.rays import Intrinsics as JIntrinsics
from niceslam_tpu.grid.hierarchy import GridConfig as JGridConfig
from niceslam_tpu.grid.hierarchy import init_grids as jinit_grids
from niceslam_tpu.io.datasets.synthetic import circular_trajectory, render_box_scene
from niceslam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.models.pretrained import load_decoders_npz as jload_npz
from niceslam_tpu.render.renderer import RenderConfig as JRenderConfig
from niceslam_tpu.slam.tracker import TrackConfig as JTrackConfig
from niceslam_tpu.slam.tracker import track_frame as jtrack_frame
from niceslam_tpu.slam.tracker import tracking_loss as jtracking_loss
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.models.decoders import tree_leaves
from niceslam_tpu_torch.ops import packed_kernels as pk
from niceslam_tpu_torch.ops import trilerp_kernels as tk
from niceslam_tpu_torch.ops.trilinear import sampler_route
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.slam.state import (
    add_keyframe,
    init_keyframe_db,
    restore_keyframes,
    snapshot_keyframes,
)
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.slam.tracker import TrackConfig, track_frame, tracking_loss

from test_torch_slam import tiny_config

torch.set_num_threads(1)

NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "pretrained_decoders.npz",
)
BOUND = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)
JINTR = JIntrinsics(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
INTR = Intrinsics(*JINTR)
JRCFG = JRenderConfig(n_samples=16, n_surface=8)
RCFG = RenderConfig(*JRCFG)
N_PX = 200  # even: the median averages the two middle values


def _rel_close(got, want, rtol, name=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def world():
    """Pretrained decoders, grids with structure, one synthetic frame and a
    camera 2-3 cm off its true pose."""
    jdec = jload_npz(NPZ, jinit_decoders(jax.random.PRNGKey(0), JDecoderConfig()))
    gcfg = JGridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25,
                       color_len=0.25, bound_divisable=0.25)
    jgrids, jbounds, sb = jinit_grids(jax.random.PRNGKey(1), BOUND, gcfg)
    rng = np.random.default_rng(0)
    jgrids = {k: jnp.asarray(rng.normal(size=g.shape).astype(np.float32) * 0.05)
              for k, g in jgrids.items()}
    poses = circular_trajectory(6, radius=0.5, arc_fraction=0.8, height_amp=0.2)
    color, depth = render_box_scene(JINTR, poses[2], BOUND * 0.9)
    init = poses[2].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.03], np.float32)
    np_state = jax.tree_util.tree_map(np.asarray, (jdec, jgrids, jbounds))
    port = (
        convert.decoders_from_jax(np_state[0], "cpu"),
        convert.grids_from_jax(np_state[1], "cpu"),
        *convert.bounds_from_jax(np_state[2], sb, "cpu"),
    )
    return (jdec, jgrids, jbounds, jnp.asarray(sb)), port, (color, depth, init)


def _jax_pixels(key, n=N_PX, edge=4):
    """The pixels ``sample_rays`` draws from ``key``, as torch tensors."""
    kj, ki = jax.random.split(key)
    j = jax.random.randint(kj, (n,), edge, JINTR.H - edge)
    i = jax.random.randint(ki, (n,), edge, JINTR.W - edge)
    to_l = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731
    return to_l(i), to_l(j)


def test_tracking_loss_and_camera_gradient_match_jax(world):
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), (color, depth, init) = world
    jcfg = JTrackConfig(pixels=N_PX, ignore_edge_H=4, ignore_edge_W=4, method="adam")
    cfg = TrackConfig(*jcfg)
    key = jax.random.PRNGKey(5)
    cam = np.asarray(jtensor_from_camera(jnp.asarray(init)))
    want, want_g = jax.value_and_grad(
        lambda c: jtracking_loss(jdec, jgrids, jbounds, jsb, JINTR, c, jnp.asarray(color),
                                 jnp.asarray(depth), key, jcfg, JRCFG)
    )(jnp.asarray(cam))
    c = torch.from_numpy(cam.copy()).requires_grad_(True)
    i, j = _jax_pixels(key)
    got = tracking_loss(dec, grids, bounds, sb, INTR, c, torch.from_numpy(color),
                        torch.from_numpy(depth), i, j, cfg, RCFG)
    (g,) = torch.autograd.grad(got, c)
    assert float(np.abs(np.asarray(want_g)).max()) > 0
    _rel_close(got.item(), float(want), 1e-5, "loss")
    _rel_close(g.numpy(), want_g, 2e-5, "d loss / d camera tensor")


@pytest.mark.parametrize("separate_lr", [False, True])
def test_adam_track_frame_matches_jax(world, separate_lr):
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), (color, depth, init) = world
    iters = 6
    jcfg = JTrackConfig(pixels=N_PX, iters=iters, lr=3e-3, separate_LR=separate_lr,
                        ignore_edge_H=4, ignore_edge_W=4, method="adam")
    key = jax.random.PRNGKey(3)
    want, want_losses = jtrack_frame(
        jdec, jgrids, jbounds, jsb, JINTR, jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(init), key, jcfg, JRCFG,
    )
    pixels = [_jax_pixels(jax.random.fold_in(key, it)) for it in range(iters)]
    got, losses = track_frame(
        dec, grids, bounds, sb, INTR, torch.from_numpy(color), torch.from_numpy(depth),
        torch.from_numpy(init), TrackConfig(*jcfg), RCFG, pixels=pixels,
    )
    want_losses = np.asarray(want_losses)
    # The same best iterate: the same iteration has the lowest pre-step loss.
    assert int(np.argmin(losses.numpy())) == int(np.argmin(want_losses))
    assert float(np.abs(np.asarray(want) - init).max()) > 1e-3  # the solve moved
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["fused", "packed"])
def test_adam_backward_asks_for_no_grid_gradient(world, monkeypatch, route):
    """The grids are not differentiated while tracking: the fused route's
    backward asks K2 for ``dv`` only, the packed route scatters nothing."""
    _, (dec, grids, bounds, sb), (color, depth, init) = world
    calls = []
    bwd, scatter = tk.trilerp_bwd, pk.scatter_corners

    def spy_bwd(grid, v, g, need_dgrid=True, need_dv=True):
        calls.append(("trilerp_bwd", need_dgrid, need_dv))
        return bwd(grid, v, g, need_dgrid, need_dv)

    def spy_scatter(*a):
        calls.append(("scatter_corners",))
        return scatter(*a)

    monkeypatch.setattr(tk, "trilerp_bwd", spy_bwd)
    monkeypatch.setattr(pk, "scatter_corners", spy_scatter)
    cfg = TrackConfig(pixels=64, iters=2, ignore_edge_H=4, ignore_edge_W=4, method="adam")
    with sampler_route(route):
        track_frame(dec, grids, bounds, sb, INTR, torch.from_numpy(color),
                    torch.from_numpy(depth), torch.from_numpy(init), cfg, RCFG,
                    gen=torch.Generator().manual_seed(0))
    if route == "fused":
        assert calls and set(calls) == {("trilerp_bwd", False, True)}
    else:
        assert calls == []


def test_cumprod_nonzero_is_torch_cumprod_bit_for_bit():
    """The transmittance's cumulative product keeps torch's values and
    derivatives (reverse mode, and forward mode under ``jacfwd`` as the GN
    tracker uses it) bit for bit on factors without zeros."""
    from niceslam_tpu_torch.core.compositing import cumprod_nonzero

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((64, 48), generator=gen) * 0.999 + 1e-10
    x[:, 0] = 1.0
    g = torch.randn(x.shape, generator=gen)
    outs = []
    for fn in (lambda y: torch.cumprod(y, dim=-1), cumprod_nonzero):
        xr = x.clone().requires_grad_(True)
        out = fn(xr)
        (gx,) = torch.autograd.grad(out, xr, g)
        with torch.no_grad():
            jac = torch.func.jacfwd(lambda p: fn(x * (1 + p[0]) + p[1:].sum()).sum(-1))(
                torch.full((6,), 1e-3))
        outs.append((out.detach(), gx, jac))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_keyframe_snapshot_restores_one_event():
    db = init_keyframe_db(4, 3, 5, "cpu")
    rng = torch.Generator().manual_seed(0)
    for k in range(5):  # wraps: slot 0 holds frame 4
        add_keyframe(db, torch.rand((3, 5, 3), generator=rng), torch.rand((3, 5), generator=rng),
                     torch.rand((4, 4), generator=rng), torch.rand((4, 4), generator=rng), k)
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in dataclasses.asdict(db).items()}
    snap = snapshot_keyframes(db)
    # One event: BA moves two poses, a keyframe is admitted over slot 1.
    db.est_c2w[2] += 1.0
    db.est_c2w[0] *= float("nan")
    add_keyframe(db, torch.zeros((3, 5, 3)), torch.zeros((3, 5)), torch.eye(4), torch.eye(4), 9)
    restore_keyframes(db, snap)
    for k, v in dataclasses.asdict(db).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k
        else:
            assert v == before[k], k


def _small_cfg(sync: str, **mapping_kw):
    cfg = tiny_config(method="adam")
    cfg = dataclasses.replace(
        cfg, sync_method=sync,
        tracking=dataclasses.replace(cfg.tracking, iters=6),
        mapping=dataclasses.replace(cfg.mapping, iters_first=40, iters=8, **mapping_kw),
    )
    return cfg


def _state(slam):
    """Copies of the published map, the keyframe DB and its host mirrors."""
    db = slam.state.keyframes
    return dict(
        grids={k: v.clone() for k, v in slam.state.grids.items()},
        decoders=[t.clone() for t in tree_leaves(slam.state.decoders)],
        kf={k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in dataclasses.asdict(db).items()},
        kf_count=slam._kf_count, kf_slots=slam._kf_slot_frame.copy(),
    )


def _assert_state_equal(a, b):
    for k in a["grids"]:
        assert torch.equal(a["grids"][k], b["grids"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["decoders"], b["decoders"]))
    for k, v in a["kf"].items():
        assert (torch.equal(v, b["kf"][k]) if isinstance(v, torch.Tensor)
                else v == b["kf"][k]), k
    assert a["kf_count"] == b["kf_count"]
    np.testing.assert_array_equal(a["kf_slots"], b["kf_slots"])


def test_async_matches_strict_bit_for_bit():
    runs = {}
    for sync in ("strict", "async"):
        cfg = _small_cfg(sync)
        reader = SyntheticBoxReader(cfg, n_frames=6, trajectory_kwargs=dict(arc_fraction=0.05))
        slam = NiceSLAM(cfg, reader=reader, device="cpu")
        res = slam.run(6)
        runs[sync] = (slam, np.stack(res["est_c2w"]))
    (s_slam, s_poses), (a_slam, a_poses) = runs["strict"], runs["async"]
    np.testing.assert_array_equal(a_poses, s_poses)
    _assert_state_equal(_state(a_slam), _state(s_slam))
    # The deferred loss curves were read at flush, the same values.
    assert a_slam.track_losses == s_slam.track_losses and len(a_slam.track_losses) == 5
    assert not a_slam._track_loss_dev and a_slam._pending_verify is None
    strip = lambda slam: [{k: v for k, v in e.items() if k != "t_wall"}  # noqa: E731
                          for e in slam.events if e["event"] == "map"]
    assert strip(a_slam) == strip(s_slam)


def test_async_rollback_with_ba_restores_the_pre_event_state():
    """A faulty BA mapping event (NaN grids, cameras and losses) is rolled
    back whole at the next event: map, keyframe DB (incl. the poses BA wrote
    back), host mirrors and the event frame's pose as before the event."""
    cfg = _small_cfg("async", BA=True, BA_min_keyframes=4, keyframe_every=1)
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=9), device="cpu")
    faults, saved = [], {}

    def corrupt(idx, outs):
        grids, decoders, cams, losses = outs
        if idx == 6 and not faults:
            faults.append(idx)
            cams = cams * torch.nan
            grids = {k: g * torch.nan for k, g in grids.items()}
            losses = losses * torch.nan
        return grids, decoders, cams, losses

    map_frame, verify = slam.map_frame, slam._verify_pending

    def spy_map_frame(frame, first=False):
        if len(slam.est_c2w) - 1 == 6:
            saved["pre"] = _state(slam)
            saved["pose"] = slam.est_c2w[6].clone()
        map_frame(frame, first)

    def spy_verify():
        n = len(slam.events)
        verify()
        if any(e["event"] == "map_rejected" for e in slam.events[n:]):
            saved["post"] = _state(slam)
            saved["post_pose"] = slam.est_c2w[6].clone()

    slam.fault_hook = corrupt
    slam.map_frame, slam._verify_pending = spy_map_frame, spy_verify
    slam.run(9)

    assert faults == [6]
    rejected = [e for e in slam.events if e["event"] == "map_rejected"]
    assert len(rejected) == 1 and rejected[0]["frame"] == 6
    _assert_state_equal(saved["post"], saved["pre"])
    assert torch.equal(saved["post_pose"], saved["pose"])
    assert saved["pre"]["kf_count"] > cfg.mapping.BA_min_keyframes  # BA ran in the event
    assert torch.isfinite(slam.state.keyframes.est_c2w).all()
    assert all(np.isfinite(p).all() for p in slam.est_c2w)
    for lvl, g in slam.state.grids.items():
        assert torch.isfinite(g).all(), lvl
