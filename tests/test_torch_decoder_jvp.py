"""The decoders' forward-mode op (``ops/decoder_kernels.py``, K6 on the card)
against ``torch.func`` on the plain MLP, the GN linearization on it against
the plain ``jacfwd`` path, and the callers that must not enter it.

CPU tolerances: rtol 1e-5 with an absolute floor of 1e-5 times the largest
reference value. Both sides compute the same fp32 function; the plain
forward-mode version takes its sums in another order (the value and the
tangents as one batched product, the fine decoder's feature term as two
products) and adds biases at other points.

The card's tests (``-m card``) run without JAX, and without the suite's
``conftest.py``, which imports it: ``python3 -m pytest --noconftest
tests/test_torch_decoder_jvp.py -m card``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from niceslam_tpu_torch.config.schema import (
    CamConfig,
    GridLenConfig,
    MappingConfig,
    RenderingConfig,
    SLAMConfig,
    TrackingConfig,
)
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.models import decoders
from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders, nice_forward
from niceslam_tpu_torch.ops import decoder_kernels as dk
from niceslam_tpu_torch.ops.trilinear import sampler_route
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.slam import tracker
from niceslam_tpu_torch.slam.system import NiceSLAM

LEVELS = ("middle", "fine", "color")
BOUND = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    scale = max(float(want.abs().max()), 1e-12)
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


def mlp_params(level, seed=0, device="cpu"):
    """One MLP of random decoders, its biases drawn too (init leaves them 0)."""
    gen = torch.Generator().manual_seed(seed)
    p = init_decoders(DecoderConfig(), gen=gen, device="cpu")[level]
    for part in p["linears"] + p["fc_c"] + [p["out"]]:
        part["b"] = 0.1 * torch.randn(part["b"].shape, generator=gen)
    return decoders.tree_map(lambda t: t.to(device), p)


def mlp_inputs(level, n, T, seed=1):
    """Points in the bound, a feature (and the fine decoder's detached
    half), and T tangents of each."""
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand((n, 3), generator=gen) * 2 - 1) * 2.0
    feat = 0.3 * torch.randn((n, 32), generator=gen)
    det = 0.3 * torch.randn((n, 32), generator=gen) if level == "fine" else None
    pdot = 0.1 * torch.randn((T, n, 3), generator=gen)
    fdot = torch.randn((T, n, 32), generator=gen)
    return pts, feat, det, pdot, fdot


def plain_mlp(p, det):
    """The MLP as the port's reverse-mode callers run it."""
    def f(x, feat):
        return decoders._mlp_forward(p, x, feat if det is None else torch.cat([feat, det], -1))
    return f


@pytest.mark.parametrize("T", [1, 3, 6])
@pytest.mark.parametrize("level", LEVELS)
def test_plain_forward_mode_equals_jacfwd_of_the_mlp(level, T):
    """The plain forward-mode version: value and T tangents equal the MLP and
    ``jacfwd`` of it along the T directions."""
    p = mlp_params(level)
    pts, feat, det, pdot, fdot = mlp_inputs(level, 200, T)
    f = plain_mlp(p, det)

    def along(c):  # the MLP along the T directions, at c = 0
        return f(pts + torch.einsum("t,tnd->nd", c, pdot),
                 feat + torch.einsum("t,tnd->nd", c, fdot))

    jac = torch.func.jacfwd(along)(torch.zeros(T))  # [N, O, T]
    val, tan = dk.decoder_jvp_plain(dk.pack_weights(p), pts, pdot, feat, fdot, det, 32,
                                    p["out"]["w"].shape[1])
    close(val, f(pts, feat))
    close(tan, jac.permute(2, 0, 1))
    assert float(tan.abs().max()) > 1.0  # the tangents are not trivially small


@pytest.mark.parametrize("level", LEVELS)
def test_op_under_jacfwd_equals_its_unbatched_jvp(level, monkeypatch):
    """``jacfwd`` through :class:`DecoderMLP` (its vmap rule: six tangents,
    one call of the compute function with T = 6) equals one ``jvp`` per
    tangent (T = 1 each)."""
    p = mlp_params(level)
    pts, feat, det, pdot, fdot = mlp_inputs(level, 100, 6)
    calls = []
    inner = dk.decoder_jvp

    def spy(*args, **kw):
        calls.append(args[2].shape[0])
        return inner(*args, **kw)

    monkeypatch.setattr(dk, "decoder_jvp", spy)

    def g(c):
        return dk.decoder_mlp(p, pts + torch.einsum("t,tnd->nd", c, pdot),
                              feat + torch.einsum("t,tnd->nd", c, fdot), det)

    jac = torch.func.jacfwd(g)(torch.zeros(6)).permute(2, 0, 1)
    assert calls == [6]  # the value and all six tangents at once
    one = torch.stack([
        torch.func.jvp(lambda a, b: dk.decoder_mlp(p, a, b, det), (pts, feat),
                       (pdot[t], fdot[t]))[1] for t in range(6)])
    close(jac, one)
    close(one, torch.func.vmap(lambda u, v: torch.func.jvp(
        plain_mlp(p, det), (pts, feat), (u, v))[1])(pdot, fdot))


def gn_world(seed=0):
    """Random grids with structure and decoders, a 48 x 64 camera inside the
    bound, depths of 0.8-1.6 m."""
    gen = torch.Generator().manual_seed(seed)
    gcfg = GridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25, color_len=0.25,
                      bound_divisable=0.25)
    grids, bounds, adj = init_grids(BOUND, gcfg, gen=gen, device="cpu")
    grids = {k: 0.3 * torch.randn(g.shape, generator=gen) for k, g in grids.items()}
    params = init_decoders(DecoderConfig(), gen=gen, device="cpu")
    for level in LEVELS:
        m = params[level]
        for part in m["linears"] + m["fc_c"] + [m["out"]]:
            part["b"] = 0.1 * torch.randn(part["b"].shape, generator=gen)
    intr = Intrinsics(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    depth = 0.8 + 0.8 * torch.rand((48, 64), generator=gen)
    i = torch.randint(4, 60, (40,), generator=gen)
    j = torch.randint(4, 44, (40,), generator=gen)
    init = torch.eye(4)
    init[:3, 3] = torch.tensor([0.1, -0.05, 0.2])
    xi = 0.01 * torch.randn(6, generator=gen)
    return params, grids, bounds, torch.as_tensor(adj), intr, init, xi, i, j, depth[j, i]


@pytest.mark.parametrize("route", ["fused", "packed"])
def test_gn_linearize_on_the_op_equals_the_plain_jacfwd(route, monkeypatch):
    """``gn_linearize``'s ``(Jd, Jc, depth, rgb, var)`` through the op equal
    those of ``jacfwd`` over the plain decoders, on both sampler routes."""
    world = gn_world()
    rcfg = RenderConfig(n_samples=8, n_surface=4)
    calls = []
    inner = dk.decoder_jvp
    monkeypatch.setattr(dk, "decoder_jvp", lambda *a, **kw: calls.append(a[2].shape[0]) or inner(*a, **kw))
    with sampler_route(route):
        got = tracker.gn_linearize(*world, rcfg)
        assert calls == [6] * 3  # middle, fine, color: value and six tangents in one call
        with monkeypatch.context() as m:
            m.setattr(tracker, "forward_mode_decoders", contextlib.nullcontext)
            want = tracker.gn_linearize(*world, rcfg)
    assert len(calls) == 3
    assert float(want[0].abs().max()) > 1e-3  # the Jacobian is not empty
    for g, w in zip(got, want):  # Jd, Jc, depth, rgb, depth_var
        close(g, w)


def _parent_nice_forward(params, grids, pts, bounds, stage):
    """``nice_forward`` of the color / fine / middle stage as the code before
    the forward-mode op wrote it."""
    feat = decoders._feat
    if stage == "middle":
        occ = decoders._mlp_forward(params["middle"], pts,
                                    feat(grids, bounds, "middle", pts))[..., 0]
        return torch.cat([torch.zeros((pts.shape[0], 3)), occ[:, None]], dim=-1)
    mid_feat = feat(grids, bounds, "middle", pts)
    mid_occ = decoders._mlp_forward(params["middle"], pts, mid_feat)[..., 0]
    own = feat(grids, bounds, "fine", pts)
    fine_in = torch.cat([own, mid_feat.detach()], dim=-1)
    occ = decoders._mlp_forward(params["fine"], pts, fine_in)[..., 0] + mid_occ
    if stage == "fine":
        return torch.cat([torch.zeros((pts.shape[0], 3)), occ[:, None]], dim=-1)
    raw = decoders._mlp_forward(params["color"], pts, feat(grids, bounds, "color", pts))
    return torch.cat([raw[:, :3], occ[:, None]], dim=-1)


@pytest.mark.parametrize("stage", ["middle", "fine", "color"])
def test_reverse_mode_callers_run_the_plain_decoders_bit_for_bit(stage, monkeypatch):
    """Outside the GN linearization ``nice_forward`` and its gradients in the
    grids and decoders are the code's before the op, bit for bit, and the op
    is not entered."""
    params, grids, bounds, *_ = gn_world(1)
    pts = (torch.rand((300, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1) * 2.0
    monkeypatch.setattr(dk, "decoder_jvp", lambda *a, **kw: pytest.fail("the op was entered"))
    leaves = [grids[k] for k in ("middle", "fine", "color")] + decoders.tree_leaves(params)
    outs = []
    for fn in (nice_forward, _parent_nice_forward):
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        raw = fn(params, grids, pts, bounds, stage)
        torch.sum(raw * torch.linspace(0.5, 1.5, raw.numel()).reshape(raw.shape)).backward()
        outs.append([raw.detach()] + [t.grad.clone() if t.grad is not None else None
                                      for t in leaves])
    for a, b in zip(*outs):
        assert (a is None and b is None) or torch.equal(a, b)


def tiny_config(gt_camera: bool):
    """A small CPU world: a mapping event every other frame, GN tracking or
    the known poses."""
    return SLAMConfig(
        dataset="synthetic",
        bound=((-2.2, 2.2), (-2.2, 2.2), (-2.2, 2.2)),
        cam=CamConfig(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0),
        grid_len=GridLenConfig(coarse=1.5, middle=0.5, fine=0.25, color=0.25,
                               bound_divisable=0.25),
        tracking=TrackingConfig(pixels=32, iters=2, ignore_edge_H=4, ignore_edge_W=4,
                                gt_camera=gt_camera),
        mapping=MappingConfig(pixels=32, iters_first=4, iters=2, every_frame=2,
                              keyframe_every=2, mapping_window_size=4, max_keyframes=16,
                              color_refine=False, BA=False),
        rendering=RenderingConfig(N_samples=8, N_surface=4),
        coarse=True,
        verbose=False,
    )


@pytest.mark.parametrize("gt_camera", [False, True])
def test_a_system_enters_the_op_only_in_its_gn_solves(gt_camera, monkeypatch):
    """A system's GN iterations call the op's compute function 6 times each
    (value and six tangents for middle, fine and color); its mapping passes,
    and a run on known poses, never."""
    cfg = tiny_config(gt_camera)
    calls = []
    inner = dk.decoder_jvp
    monkeypatch.setattr(dk, "decoder_jvp", lambda *a, **kw: calls.append(a[2].shape[0]) or inner(*a, **kw))
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=3), seed=3, device="cpu")
    slam.n_imgs = 3
    for frame in SyntheticBoxReader(cfg, n_frames=3):
        slam.step(frame)
    slam.flush()
    iters = slam.timer.replays.get("track", 0)
    assert (iters == 0) == gt_camera
    assert calls == [6] * 3 * iters
    assert slam.timer.replays.get("map.middle", 0) + slam.timer.replays.get("map.color", 0) > 0


# ------------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


# The kernel's tolerance on the card (``dk.CARD_RTOL``, ``dk.KINKS``; their
# reason beside them): at most KINKS of the tangents, whose ReLU mask flips
# at a pre-activation within rounding of 0, may differ beyond CARD_RTOL.
def close_but_kinks(got, want):
    off = dk.tangents_off(got, want)
    assert off <= dk.KINKS, f"{off:.3e} of the tangents off by more than {dk.CARD_RTOL}"


@pytest.mark.card
@pytest.mark.parametrize("level", LEVELS)
def test_kernel_matches_its_plain_version_on_the_card(card, level):
    """K6 at the GN linearization's shape (48,000 points, T = 6): the value
    bit-equal to the T = 0 launch's, value and tangents within
    ``dk.CARD_RTOL`` of the plain version on the card (tangents but for
    ``dk.KINKS``); ten tangents go
    in two launches with the same bits."""
    p = mlp_params(level, device=card)
    pts, feat, det, pdot, fdot = (None if x is None else x.to(card)
                                  for x in mlp_inputs(level, 48_000, 6))
    w, O = dk.pack_weights(p), p["out"]["w"].shape[1]
    before = dk.LAUNCHES["decoder_jvp"]
    val, tan = dk.decoder_jvp(w, pts, pdot, feat, fdot, det, 32, O)
    val0, tan0 = dk.decoder_jvp(w, pts, pdot[:0], feat, fdot[:0], det, 32, O)
    assert dk.LAUNCHES["decoder_jvp"] == before + 2
    assert torch.equal(val, val0) and tan0.shape == (0, 48_000, O)
    pval, ptan = dk.decoder_jvp_plain(w, pts, pdot, feat, fdot, det, 32, O)
    close(val, pval, dk.CARD_RTOL)
    close_but_kinks(tan, ptan)
    # Ten tangents: 6 and 4 (padded with zero tangents) in two launches.
    pd10, fd10 = torch.cat([pdot, pdot[:4]]), torch.cat([fdot, fdot[:4]])
    val10, tan10 = dk.decoder_jvp(w, pts, pd10, feat, fd10, det, 32, O)
    assert torch.equal(val10, val0)
    assert torch.equal(tan10[:6], tan) and torch.equal(tan10[6:], tan[:4])


@pytest.mark.card
def test_a_graphed_gn_replay_launches_k6_three_times_and_a_mapping_replay_never(card):
    """In the captured programs of a system on the card a GN iteration
    launches K6 three times (middle, fine, color: the value and six
    tangents each) and a mapping iteration never; the run's launches add
    up."""
    cfg = tiny_config(False)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, pixels=1000))
    dk.reset_launches()
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=3), seed=3, device=card)
    slam.n_imgs = 3
    for frame in SyntheticBoxReader(cfg, n_frames=3):
        slam.step(frame)
    slam.flush()
    caps = slam._programs.captures
    track = [c for c in caps if c.signature.startswith("track")]
    maps = [c for c in caps if c.signature.startswith("map")]
    assert track and maps
    assert all(c.launches["decoder_jvp"] == 3 for c in track)
    assert all(c.launches.get("decoder_jvp", 0) == 0 for c in maps)
    iters = slam.timer.replays["track"]
    by_t = {}
    for (t, n), c in dk.JVP_TALLY.items():
        by_t[t] = by_t.get(t, 0) + c
    assert by_t == {6: 3 * iters}
