"""The port's tracker, mapper and keyframe geometry against the JAX package,
on identical parameters (carried across with convert.py) and identical
random draws (the JAX draws are replayed here and injected into the port).

Tolerances: 1e-4 on the GN pose and on the mapping loss and its gradients
(relative to each gradient's largest entry); 1e-6 on the Adam step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from niceslam_tpu.slam import keyframes as jkf
from niceslam_tpu.slam import mapper as jmapper
from niceslam_tpu.slam.tracker import TrackConfig as JTrackConfig
from niceslam_tpu.slam.tracker import _track_frame_gn as jtrack_gn
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.config.schema import MappingConfig
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.slam import keyframes as kf
from niceslam_tpu_torch.slam import mapper
from niceslam_tpu_torch.slam.tracker import TrackConfig, gn_prior, track_frame

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


def _rel_close(got, want, rtol=1e-4, name=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=rtol * scale, err_msg=name
    )


@pytest.fixture(scope="module")
def world():
    """Pretrained decoders, grids with structure, three synthetic frames."""
    jdec = jload_npz(NPZ, jinit_decoders(jax.random.PRNGKey(0), JDecoderConfig()))
    gcfg = JGridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25,
                       color_len=0.25, bound_divisable=0.25)
    jgrids, jbounds, sb = jinit_grids(jax.random.PRNGKey(1), BOUND, gcfg)
    rng = np.random.default_rng(0)
    jgrids = {k: jnp.asarray(rng.normal(size=g.shape).astype(np.float32) * 0.05)
              for k, g in jgrids.items()}
    poses = circular_trajectory(6, radius=0.5, arc_fraction=0.8, height_amp=0.2)
    frames = [render_box_scene(JINTR, poses[k], BOUND * 0.9) for k in (0, 2, 4)]
    np_state = jax.tree_util.tree_map(np.asarray, (jdec, jgrids, jbounds))
    port = (
        convert.decoders_from_jax(np_state[0], "cpu"),
        convert.grids_from_jax(np_state[1], "cpu"),
        *convert.bounds_from_jax(np_state[2], sb, "cpu"),
    )
    return (jdec, jgrids, jbounds, jnp.asarray(sb)), port, poses, frames


@pytest.mark.parametrize("iters,offset_sigma", [(1, 0.0), (1, 0.05), (2, 0.05)])
def test_gn_iterations_match_jax(world, iters, offset_sigma):
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), poses, frames = world
    color, depth = frames[1]
    init = poses[2].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.01], np.float32)
    jcfg = JTrackConfig(pixels=200, iters=iters, ignore_edge_H=4, ignore_edge_W=4,
                        gn_depth_offset_sigma=offset_sigma)
    key = jax.random.PRNGKey(3)
    want, want_losses = jtrack_gn(
        jdec, jgrids, jbounds, jsb, JINTR, jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(init), key, jcfg, JRCFG,
    )
    pixels = []
    for it in range(iters):
        kj, ki = jax.random.split(jax.random.fold_in(key, it))
        j = jax.random.randint(kj, (200,), 4, JINTR.H - 4)
        i = jax.random.randint(ki, (200,), 4, JINTR.W - 4)
        pixels.append((torch.from_numpy(np.array(i)).long(), torch.from_numpy(np.array(j)).long()))
    cfg = TrackConfig(pixels=200, iters=iters, ignore_edge_H=4, ignore_edge_W=4,
                      gn_depth_offset_sigma=offset_sigma)
    got, losses = track_frame(
        dec, grids, bounds, sb, INTR, torch.from_numpy(color), torch.from_numpy(depth),
        torch.from_numpy(init), cfg, RCFG, pixels=pixels,
    )
    assert float(np.abs(np.asarray(want) - init).max()) > 1e-3  # the solve moved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4, atol=1e-4)


def _mapping_inputs(world):
    (_, _, _, _), _, poses, frames = world
    F = 4
    colors = np.zeros((F, JINTR.H, JINTR.W, 3), np.float32)
    depths = np.zeros((F, JINTR.H, JINTR.W), np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for w, k in enumerate((0, 2, 4)):
        colors[w], depths[w] = frames[w]
        c2ws[w] = poses[k]
    cams = np.asarray(jax.vmap(jtensor_from_camera)(jnp.asarray(c2ws)))
    valid = np.array([True, True, True, False])
    fixed = np.array([True, False, False, True])
    return colors, depths, cams, valid, fixed


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_mapping_loss_and_grads_match_jax(world, stage):
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), _, _ = world
    colors, depths, cams, valid, fixed = _mapping_inputs(world)
    n = 300
    key = jax.random.PRNGKey(11)
    kw = dict(tv_weight=0.5, fs_weight=1.0, fs_band=0.05)

    def jloss(p):
        return jmapper.mapping_loss(
            p, jbounds, jsb, JINTR, jnp.asarray(colors), jnp.asarray(depths),
            jnp.asarray(valid), jnp.asarray(fixed), key, stage, 0.2, JRCFG, n, **kw,
        )

    jparams = {"grids": jgrids, "decoders": jdec, "cams": jnp.asarray(cams)}
    want_loss, want_g = jax.value_and_grad(jloss)(jparams)

    kf_key, kj, ki = jax.random.split(key, 3)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    fidx = jax.random.categorical(kf_key, logits, shape=(n,))
    j = jax.random.randint(kj, (n,), 0, JINTR.H)
    i = jax.random.randint(ki, (n,), 0, JINTR.W)
    to_l = lambda a: torch.from_numpy(np.array(a)).long()  # noqa: E731

    params = {
        "grids": {k: v.clone().requires_grad_(True) for k, v in grids.items()},
        "decoders": convert.to_torch(jax.tree_util.tree_map(np.asarray, jdec), "cpu"),
        "cams": torch.from_numpy(cams.copy()).requires_grad_(True),
    }
    dec_leaves = {}
    for lvl, sub in params["decoders"].items():
        for name in ("linears", "fc_c"):
            for li, lin in enumerate(sub.get(name, [])):
                for wb in ("w", "b"):
                    lin[wb].requires_grad_(True)
                    dec_leaves[(lvl, name, li, wb)] = lin[wb]
    loss = mapper.mapping_loss(
        params, bounds, sb, INTR, torch.from_numpy(colors), torch.from_numpy(depths),
        torch.from_numpy(valid), torch.from_numpy(fixed), to_l(fidx), to_l(i), to_l(j),
        stage, 0.2, RCFG, **kw,
    )
    loss.backward()
    _rel_close(loss.item(), float(want_loss), name="loss")
    for lvl in grids:
        want = np.asarray(want_g["grids"][lvl])
        g = params["grids"][lvl].grad
        _rel_close(np.zeros_like(want) if g is None else g.numpy(), want, name=f"grid {lvl}")
    _rel_close(params["cams"].grad.numpy(), want_g["cams"], name="cams")
    assert np.abs(np.asarray(want_g["cams"])[1:3]).max() > 0  # BA gradient reached
    for (lvl, name, li, wb), t in dec_leaves.items():
        want = want_g["decoders"][lvl][name][li][wb]
        got = np.zeros(want.shape, np.float32) if t.grad is None else t.grad.numpy()
        _rel_close(got, want, name=f"{lvl}/{name}/{li}/{wb}")


@pytest.mark.parametrize("offset_sigma", [0.0, 0.05])
def test_gn_prior_fills_the_values_as_before(offset_sigma):
    """The GN prior is filled on the device (no copy from the host): the
    float32 values of the tensor the host used to copy, bit for bit."""
    cfg = TrackConfig(gn_prior_sigma_r=0.015, gn_prior_sigma_t=0.07,
                      gn_depth_offset_sigma=offset_sigma)
    diag = [1.0 / cfg.gn_prior_sigma_r**2] * 3 + [1.0 / cfg.gn_prior_sigma_t**2] * 3
    if offset_sigma > 0:
        diag.append(1.0 / offset_sigma**2)
    want = torch.diag(torch.tensor(diag, dtype=torch.float32))
    got = gn_prior(cfg, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_adam_step_matches_optax_scale_by_adam():
    rng = np.random.default_rng(5)
    grids = {"middle": torch.from_numpy(rng.normal(size=(3, 4, 5, 2)).astype(np.float32)),
             "fine": torch.from_numpy(rng.normal(size=(3, 4, 5, 2)).astype(np.float32))}
    cams = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
    pcfg = mapper.ProgConfig(n_pixels=1, w_color_loss=0.0, frustum=True,
                             dec_train=mapper.dec_train_table(MappingConfig().stage_lr,
                                                              mapper.MapOptConfig()),
                             ba=True)
    pp = mapper.make_pass_params(grids, {}, cams, pcfg)
    state = mapper.init_opt_state(pp)
    masks = {"middle": torch.from_numpy((rng.uniform(size=(3, 4, 5, 1)) > 0.3).astype(np.float32)),
             "fine": torch.ones((3, 4, 5, 1))}
    jparams = [np.array(t.detach()) for t in pp.leaves]
    opt = optax.scale_by_adam()
    jstate = opt.init(jparams)
    lr_g = np.array([0.0, 0.1, 0.05, 0.0], np.float32)
    for step in range(4):
        grads = [rng.normal(size=t.shape).astype(np.float32) for t in jparams]
        if step == 2:
            grads[1] = np.zeros_like(grads[1])  # a stage that does not touch "fine"
        lr_cam = 0.0 if step < 2 else 1e-3
        upd, jstate = opt.update(grads, jstate)
        lrs = [lr_g[1], lr_g[2], lr_cam]
        mks = [np.asarray(masks["middle"]), 1.0, 1.0]
        jparams = [p - lr * np.asarray(u) * mk for p, u, lr, mk in zip(jparams, upd, lrs, mks)]
        tg = [None if (step == 2 and k == 1) else torch.from_numpy(g) for k, g in enumerate(grads)]
        mapper.adam_update(pp, tg, state, lr_g, np.zeros(4, np.float32), lr_cam, masks)
        for t, w in zip(pp.leaves, jparams):
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-6, atol=1e-6)
        for m_t, m_j in zip(state.mu, jstate.mu):
            np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-7)
    assert state.count == int(jstate.count)


def test_stage_plan_and_schedule_match_jax():
    m = MappingConfig()
    for n, coarse in [(60, False), (1500, False), (60, True), (7, False)]:
        plan = mapper.build_stage_plan(n, 0.4, 0.6, m.stage_lr, coarse=coarse)
        jplan = jmapper.build_stage_plan(n, 0.4, 0.6, m.stage_lr, coarse=coarse)
        assert [(s, k) for s, k, _ in plan] == [(s, k) for s, k, _ in jplan]
        cfg = mapper.MapOptConfig(BA=True, lr_factor=5.0)
        jcfg = jmapper.MapOptConfig(*cfg)
        chunks, reals = mapper.chunked_schedule(plan, cfg, 60)
        jchunks, jreals = jmapper.chunked_schedule(jplan, jcfg, 60)
        assert reals == jreals
        for c, jc in zip(chunks, jchunks):
            for a, b in zip(c, jc):
                np.testing.assert_array_equal(a, np.asarray(b))
        assert mapper.dec_train_table(m.stage_lr, cfg) == jmapper.dec_train_table(m.stage_lr, jcfg)


def test_frustum_masks_and_overlap_match_jax(world):
    (_, jgrids, jbounds, _), (_, grids, bounds, _), poses, frames = world
    colors, depths, _, valid, _ = _mapping_inputs(world)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for w, k in enumerate((0, 2, 4)):
        c2ws[w] = poses[k]
    want = jkf.frustum_masks_for_levels(
        jnp.asarray(c2ws), jnp.asarray(valid), jnp.asarray(depths), JINTR, jbounds, jgrids
    )
    got = kf.frustum_masks_for_levels(
        torch.from_numpy(c2ws), torch.from_numpy(valid), torch.from_numpy(depths),
        INTR, bounds, grids,
    )
    for lvl in grids:
        w, g = np.asarray(want[lvl]), got[lvl].numpy()
        assert w.sum() > 0
        # Voxel centers whose projection rounds to a pixel border may flip.
        assert np.mean(w != g) < 2e-3, lvl
    key = jax.random.PRNGKey(2)
    want_o = jkf.keyframe_overlap_percentages(
        key, JINTR, jnp.asarray(poses[2]), jnp.asarray(frames[1][1]),
        jnp.asarray(frames[1][0]), jnp.asarray(c2ws), pixels=100,
    )
    kj, ki = jax.random.split(key)
    j = torch.from_numpy(np.array(jax.random.randint(kj, (100,), 0, JINTR.H))).long()
    i = torch.from_numpy(np.array(jax.random.randint(ki, (100,), 0, JINTR.W))).long()
    got_o = kf.keyframe_overlap_percentages(
        INTR, torch.from_numpy(poses[2]), torch.from_numpy(frames[1][1]),
        torch.from_numpy(frames[1][0]), torch.from_numpy(c2ws), i, j,
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-3)
