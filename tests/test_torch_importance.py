"""The importance pass (``rendering.N_importance > 0``) of the port against
the JAX package on the CPU: ``sample_pdf``, ``render_rays`` on every stage,
``render_image``, a GN step and an Adam tracking solve, a mapping pass
through ``run_schedule``, and the system's ``MappingProgram`` against
``run_schedule``. Inputs are made from numpy seeds (the JAX draws replayed
where a function draws).

Both packages draw the importance samples at ``u = linspace(0, 1, n)``
(``niceslam_tpu/core/sampling.py:94-107``, the port's
``core/sampling.py``). The last one, ``u = 1``, is
``bins[below] + t * (bins[above] - bins[below])`` with ``t = (1 - cdf_b) /
(cdf_a - cdf_b)``: a ratio of two differences of numbers near 1, where the
two frameworks' ``cumsum`` round apart by ~6e-8. With the last bin's
probability near 1e-5 that ratio is ill-conditioned, and where the two cdfs
end on opposite sides of 1.0 (``searchsorted`` picks another bin) or the
probability sits at the 1e-5 guard, the sample jumps up to a whole bin
(``test_sample_pdf_flip_is_confined_to_the_last_sample``; ROADMAP queue 3).
The port copies the reference and so does not fix it. Where it matters:

- a moved sample lies behind the surface, where the compositing weight is
  below 1e-5, so ``rgb``, ``depth``, ``depth_var`` and ``weights`` keep
  their usual tolerances on every row, and ``z_vals`` and ``occ`` are
  compared on every row whose last importance sample agrees; the other
  rows are counted and must differ only in that sample, between the last
  two bin edges;
- the mapping pass against JAX takes the importance samples that the JAX
  pass drew (``torch_ranks.forced_importance``) after drawing its own,
  which are compared on their own: over a pass the two packages' weights
  part by more than rounding, the samples of a few rows move, and with
  the free-space term on (or, without it, through Adam's steps on the
  tiny gradients at a moved sample) a moved sample changes the pass past
  any tolerance. With the same samples the pass is held as
  ``test_torch_tracker_mapper._adam_close`` holds an Adam pass;
- the program against ``run_schedule`` is the same framework and the same
  ops: bit for bit, with the free-space term on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.core import sampling as jsampling
from niceslam_tpu.core.pose import tensor_from_camera as jtensor_from_camera
from niceslam_tpu.core.rays import Intrinsics as JIntrinsics
from niceslam_tpu.io.datasets.synthetic import circular_trajectory
from niceslam_tpu.render.renderer import RenderConfig as JRenderConfig
from niceslam_tpu.render.renderer import render_image as jrender_image
from niceslam_tpu.render.renderer import render_rays as jrender_rays
from niceslam_tpu.slam import mapper as jmapper
from niceslam_tpu.slam.tracker import TrackConfig as JTrackConfig
from niceslam_tpu.slam.tracker import _track_frame_gn as jtrack_gn
from niceslam_tpu.slam.tracker import track_frame as jtrack_frame
from niceslam_tpu_torch.config.schema import MappingConfig
from niceslam_tpu_torch.core import sampling
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.models.decoders import tree_leaves
from niceslam_tpu_torch.models.pretrained import _flatten_with_keys
from niceslam_tpu_torch.render.renderer import RenderConfig, render_image, render_rays
from niceslam_tpu_torch.slam import mapper
from niceslam_tpu_torch.slam.programs import Programs
from niceslam_tpu_torch.slam.tracker import TrackConfig, track_frame

from test_torch_decoders_render import STAGES
from test_torch_decoders_render import world as render_world  # noqa: F401  (fixture)
from test_torch_tracker_mapper import INTR, JINTR, _adam_close
from test_torch_tracker_mapper import world as slam_world  # noqa: F401  (fixture)
from torch_ranks import forced_importance

torch.set_num_threads(1)

IMP = 8
JRCFG = JRenderConfig(n_samples=16, n_surface=8, n_importance=IMP)
RCFG = RenderConfig(*JRCFG)


# ------------------------------------------------------------ sample_pdf
def test_sample_pdf_flip_is_confined_to_the_last_sample():
    """``sample_pdf`` of both packages on the same compositing-like weights
    (4,096 rows of 46 bins, summing to 0.3-1.0), 16 deterministic samples:
    every sample but the last agrees within 1e-4 on every row; the last
    one, ``u = 1``, differs on some rows, up to more than half a bin, and
    always between the last two bin edges (the module docstring). Among
    the rows it moves are rows whose two cdfs end on opposite sides of
    1.0."""
    rng = np.random.default_rng(5)
    n_rows, n_bins, n = 4096, 46, 16
    bins = np.sort(rng.uniform(0.1, 3.0, (n_rows, n_bins + 1)), -1).astype(np.float32)
    alpha = 1.0 / (1.0 + np.exp(-(rng.normal(size=(n_rows, n_bins)) * 3.0 - 2.0)))
    trans = np.cumprod(np.concatenate([np.ones((n_rows, 1)), 1.0 - alpha[:, :-1]], -1), -1)
    w = alpha * trans
    w = (w * rng.uniform(0.3, 1.0, (n_rows, 1)) / w.sum(-1, keepdims=True)).astype(np.float32)
    got = sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n).numpy()
    want = np.asarray(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n))
    err = np.abs(got - want)
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=0, atol=1e-4)
    moved = err[:, -1] > 1e-4
    assert moved.any()
    for z in (got[:, -1], want[:, -1]):
        assert ((z >= bins[:, -2]) & (z <= bins[:, -1])).all()
    width = bins[:, -1] - bins[:, -2]
    assert float((err[:, -1] / width).max()) > 0.5
    # Each package's cdf as its sample_pdf computes it.
    tw = torch.from_numpy(w) + 1e-5
    cdf_t = torch.cumsum(tw / tw.sum(-1, keepdim=True), -1)[:, -1].numpy()
    jw = jnp.asarray(w) + 1e-5
    cdf_j = np.asarray(jnp.cumsum(jw / jnp.sum(jw, -1, keepdims=True), -1))[:, -1]
    straddle = (cdf_t >= 1.0) != (cdf_j >= 1.0)
    assert (moved & straddle).any()
    print(f"last sample moved on {int(moved.sum())} of {n_rows} rows (largest "
          f"{float(err[:, -1].max()):.4f}); cdfs straddle 1.0 on {int(straddle.sum())}, "
          f"both on {int((moved & straddle).sum())}")


# ----------------------------------------------------------- render_rays
def _rays():
    rng = np.random.default_rng(2)
    n = 64
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    gt = rng.uniform(0.5, 2.5, n).astype(np.float32)
    gt[:4] = 0.0
    return o, d, gt


@pytest.mark.parametrize("stage", STAGES)
def test_render_rays_with_importance(render_world, stage):
    """``render_rays`` at ``n_importance = 8`` (64 rays, 16 + 8 samples,
    the shipped decoders): ``rgb``, ``depth``, ``depth_var`` and
    ``weights`` within ``test_render_rays``' 1e-4 on every row;
    ``z_vals``, ``occ`` and ``sample_valid`` on every row whose last
    importance sample agrees within 1e-5, the rounding of the others. On
    the other rows (counted) every other importance sample agrees within
    1e-4 and the last one lies between the last two bin edges in both
    packages."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb) = render_world
    o, d, gt = _rays()
    jcfg = JRenderConfig(n_samples=16, n_surface=8, surface_band=0.03, n_importance=IMP)
    cfg = RenderConfig(*jcfg)
    jargs = (jdec, jgrids, jbounds, jsb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), stage)
    args = (dec, grids, bounds, sb, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(gt), stage)
    want, got = jrender_rays(*jargs, jcfg), render_rays(*args, cfg)
    for name in ("rgb", "depth", "depth_var", "weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # Each package's importance samples, from its own first evaluation.
    jfirst = jrender_rays(*jargs, jcfg._replace(n_importance=0))
    first = render_rays(*args, cfg._replace(n_importance=0))
    z = first.z_vals.numpy()
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    imp = sampling.sample_pdf(torch.from_numpy(mids), first.weights[:, 1:-1], IMP).numpy()
    jz = jfirst.z_vals
    jimp = np.asarray(jsampling.sample_pdf(0.5 * (jz[:, 1:] + jz[:, :-1]),
                                           jfirst.weights[:, 1:-1], IMP))
    np.testing.assert_allclose(imp[:, :-1], jimp[:, :-1], rtol=0, atol=1e-4)
    agree = np.abs(imp[:, -1] - jimp[:, -1]) <= 1e-5
    for last in (imp[~agree, -1], jimp[~agree, -1]):
        assert ((last >= mids[~agree, -2] - 1e-4) & (last <= mids[~agree, -1] + 1e-4)).all()
    for name in ("z_vals", "occ"):
        np.testing.assert_allclose(getattr(got, name).numpy()[agree],
                                   np.asarray(getattr(want, name))[agree],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.sample_valid.numpy()[agree],
                                  np.asarray(want.sample_valid)[agree])
    assert got.z_vals.shape == (64, 16 + 8 + IMP)
    print(f"{stage}: the last importance sample moved on {int((~agree).sum())} of 64 rays")


def test_render_image_with_importance(render_world):
    """``render_image`` at ``n_importance = 8`` (chunks of 8 rows, H = 21
    with padding) against the JAX package's, with and without depth: every
    output within the 1e-4 of ``test_render_rays`` (a chunk is one
    ``render_rays``; the 40 samples a ray composite a few weights 2e-5
    apart, past ``test_render_image_matches_jax``'s 1e-5 at 24)."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb) = render_world
    rng = np.random.default_rng(6)
    intr = dict(H=21, W=16, fx=12.0, fy=12.0, cx=8.0, cy=10.5)
    c2w = circular_trajectory(6)[2]
    depth = rng.uniform(0.6, 2.4, (intr["H"], intr["W"])).astype(np.float32)
    jcfg = JRenderConfig(n_samples=16, n_surface=8, surface_band=0.03, n_importance=IMP)
    for gt in (depth, None):
        want = jrender_image(jdec, jgrids, jbounds, jsb, JIntrinsics(**intr), jnp.asarray(c2w),
                             None if gt is None else jnp.asarray(gt), "color", jcfg, 8)
        got = render_image(dec, grids, bounds, sb, Intrinsics(**intr), torch.from_numpy(c2w),
                           None if gt is None else torch.from_numpy(gt), "color",
                           RenderConfig(*jcfg), 8)
        for name in ("rgb", "depth", "depth_var", "weights"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)
        assert got.weights.shape[-1] == (16 + 8 if gt is not None else 16) + IMP


# -------------------------------------------------------------- trackers
def test_gn_step_with_importance_matches_jax(slam_world):
    """Two GN iterations (``jacfwd`` through both evaluations, K1 with
    ``dV/dv`` on a card) with the depth-offset prior, at ``n_importance =
    8``, against the JAX solve on its draws: pose and losses within 1e-4."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), poses, frames = slam_world
    color, depth = frames[1]
    init = poses[2].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.01], np.float32)
    iters, key = 2, jax.random.PRNGKey(3)
    jcfg = JTrackConfig(pixels=200, iters=iters, ignore_edge_H=4, ignore_edge_W=4,
                        gn_depth_offset_sigma=0.05)
    want, want_losses = jtrack_gn(jdec, jgrids, jbounds, jsb, JINTR, jnp.asarray(color),
                                  jnp.asarray(depth), jnp.asarray(init), key, jcfg, JRCFG)
    pixels = []
    for it in range(iters):
        kj, ki = jax.random.split(jax.random.fold_in(key, it))
        j = jax.random.randint(kj, (200,), 4, JINTR.H - 4)
        i = jax.random.randint(ki, (200,), 4, JINTR.W - 4)
        pixels.append((torch.from_numpy(np.array(i)).long(), torch.from_numpy(np.array(j)).long()))
    got, losses = track_frame(dec, grids, bounds, sb, INTR, torch.from_numpy(color),
                              torch.from_numpy(depth), torch.from_numpy(init),
                              TrackConfig(*jcfg), RCFG, pixels=pixels)
    assert float(np.abs(np.asarray(want) - init).max()) > 1e-3  # the solve moved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4, atol=1e-4)


def test_adam_solve_with_importance_matches_jax(slam_world):
    """Six Adam iterations of ``tracking_loss`` at ``n_importance = 8``
    against the JAX solve on its draws, at
    ``test_adam_track_frame_matches_jax``'s tolerances: the same best
    iterate, losses within rtol 1e-4, the pose within 1e-4."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), poses, frames = slam_world
    color, depth = frames[1]
    init = poses[2].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.03], np.float32)
    iters, key = 6, jax.random.PRNGKey(3)
    jcfg = JTrackConfig(pixels=200, iters=iters, lr=3e-3, ignore_edge_H=4, ignore_edge_W=4,
                        method="adam")
    want, want_losses = jtrack_frame(jdec, jgrids, jbounds, jsb, JINTR, jnp.asarray(color),
                                     jnp.asarray(depth), jnp.asarray(init), key, jcfg, JRCFG)
    pixels = []
    for it in range(iters):
        kj, ki = jax.random.split(jax.random.fold_in(key, it))
        j = jax.random.randint(kj, (200,), 4, JINTR.H - 4)
        i = jax.random.randint(ki, (200,), 4, JINTR.W - 4)
        pixels.append((torch.from_numpy(np.array(i)).long(), torch.from_numpy(np.array(j)).long()))
    got, losses = track_frame(dec, grids, bounds, sb, INTR, torch.from_numpy(color),
                              torch.from_numpy(depth), torch.from_numpy(init),
                              TrackConfig(*jcfg), RCFG, pixels=pixels)
    want_losses = np.asarray(want_losses)
    assert int(np.argmin(losses.numpy())) == int(np.argmin(want_losses))
    assert float(np.abs(np.asarray(want) - init).max()) > 1e-3
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- mapping
def _window(slam_world):
    """Three frames of the box scene in a window of four (the last slot
    empty), the first camera fixed."""
    _, _, poses, frames = slam_world
    F = 4
    colors = np.zeros((F, JINTR.H, JINTR.W, 3), np.float32)
    depths = np.zeros((F, JINTR.H, JINTR.W), np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for w, k in enumerate((0, 2, 4)):
        colors[w], depths[w] = frames[w]
        c2ws[w] = poses[k]
    cams = np.asarray(jax.vmap(jtensor_from_camera)(jnp.asarray(c2ws)))
    return colors, depths, cams, np.array([True, True, True, False]), \
        np.array([True, False, False, True])


def _pass(grids, n_iters, fs_weight, seed):
    """A staged pass (BA, TV, every decoder trained), its frustum masks."""
    plan = mapper.build_stage_plan(n_iters, 0.4, 0.6, MappingConfig().stage_lr)
    cfg = mapper.MapOptConfig(BA=True, train_all_decoders=True, tv_weight=0.1,
                              fs_weight=fs_weight)
    pcfg = mapper.ProgConfig(n_pixels=64, w_color_loss=cfg.w_color_loss, frustum=True,
                             dec_train=mapper.dec_train_from_plan(plan, cfg), ba=True,
                             tv_weight=0.1, fs_weight=fs_weight)
    rng = np.random.default_rng(seed)
    masks = {lvl: (rng.uniform(size=g.shape[:3] + (1,)) > 0.2).astype(np.float32)
             for lvl, g in grids.items()}
    return plan, cfg, pcfg, masks


def _jax_importance_samples(fn, *args):
    """``fn(*args)`` (a jitted JAX function) traced afresh with a callback
    around the JAX package's ``sample_pdf``; returns its result and the
    importance samples of each call, in order."""
    orig, table = jsampling.sample_pdf, []

    def recorded(bins, weights, n_samples, key=None):
        z = orig(bins, weights, n_samples, key)
        jax.debug.callback(lambda a: table.append(np.asarray(a)), z)
        return z

    jsampling.sample_pdf = recorded
    try:
        out = jax.jit(fn.__wrapped__, static_argnames=("intr", "pcfg", "rcfg"))(*args)
        jax.block_until_ready(out)
    finally:
        jsampling.sample_pdf = orig
    return out, table


def test_run_schedule_with_importance_matches_jax(slam_world):
    """A staged pass of five iterations through the port's ``run_schedule``
    at ``n_importance = 8``, with BA, TV and the free-space term, against
    the JAX package's on the JAX draws (``fold_in(key, it)``), the port
    taking the JAX pass's importance samples after drawing its own: losses
    within rtol 2e-4 / atol 1e-5; grids, decoders and cameras as
    ``_adam_close`` holds a pass. In the first iteration (the same
    parameters) the port's own samples agree with the JAX pass's but for
    the last sample of a row; the rows whose own samples moved are counted
    and printed for every iteration."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb), _, _ = slam_world
    colors, depths, cams, valid, fixed = _window(slam_world)
    n_iters = 5
    plan, cfg, pcfg, masks = _pass(grids, n_iters, 1.0, 3)
    jplan = jmapper.build_stage_plan(n_iters, 0.4, 0.6, MappingConfig().stage_lr)
    jcfg = jmapper.MapOptConfig(*cfg)
    jpcfg = jmapper.ProgConfig(n_pixels=64, w_color_loss=cfg.w_color_loss, frustum=True,
                               ba=True, dec_train=pcfg.dec_train, tv_weight=0.1, fs_weight=1.0)
    key = jax.random.PRNGKey(13)
    jparams = {"grids": jgrids, "decoders": jdec, "cams": jnp.asarray(cams)}
    (jg, jd, jc, _, jl), table = _jax_importance_samples(
        jmapper.run_schedule, jgrids, jdec, jnp.asarray(cams),
        jax.tree_util.tree_map(jnp.asarray, masks), jbounds, jsb, JINTR, jnp.asarray(colors),
        jnp.asarray(depths), jnp.asarray(valid), jnp.asarray(fixed), key,
        jmapper.schedule_arrays(jplan, jcfg), jmapper.init_opt_state(jparams), jpcfg, JRCFG)
    assert len(table) == n_iters and table[0].shape == (64, IMP)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    pixels = {}
    for it in range(n_iters):
        kf_key, kj, ki = jax.random.split(jax.random.fold_in(key, it), 3)
        fidx = jax.random.categorical(kf_key, logits, shape=(64,))
        j = jax.random.randint(kj, (64,), 0, JINTR.H)
        i = jax.random.randint(ki, (64,), 0, JINTR.W)
        pixels[it] = tuple(torch.from_numpy(np.array(a, np.int64)) for a in (fidx, i, j))
    sched = mapper.schedule_arrays(plan, cfg)
    pp = mapper.make_pass_params(grids, dec, torch.from_numpy(cams.copy()), pcfg)
    with forced_importance(table) as own:
        losses = mapper.run_schedule(
            pp, mapper.init_opt_state(pp), sched,
            {k: torch.from_numpy(m) for k, m in masks.items()}, bounds, sb, INTR,
            torch.from_numpy(colors), torch.from_numpy(depths), valid, fixed, pcfg, RCFG,
            pixels=pixels)
    assert len(own) == n_iters
    # The first iteration starts from the same parameters: only the last
    # sample of a row moves (test_render_rays_with_importance).
    np.testing.assert_allclose(own[0].numpy()[:, :-1], table[0][:, :-1], rtol=0, atol=1e-4)
    moved = [int((np.abs(z.numpy() - t) > 1e-4).any(-1).sum()) for z, t in zip(own, table)]
    print("rows whose own importance samples moved from the JAX pass's, per iteration:", moved)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=2e-4, atol=1e-5)
    c, g, d = pp.params["cams"], pp.params["grids"], pp.params["decoders"]
    assert float(np.abs(np.asarray(jc) - cams).max()) > 1e-5  # BA moved a camera
    lvl_of = mapper.LEVEL_ORDER.index
    pairs = [("cams", c, jc, sched.lr_cam.sum())]
    pairs += [(f"grid {lvl}", g[lvl], jg[lvl], sched.lr_grids[:, lvl_of(lvl)].sum())
              for lvl in grids]
    for key_, t in _flatten_with_keys(d):
        w = jd
        for part in key_.split("/"):
            w = w[int(part) if isinstance(w, list) else part]
        pairs.append((key_, t, w, sched.lr_dec[:, lvl_of(key_.split("/")[0])].sum()))
    _adam_close(pairs)


def test_mapping_program_with_importance_equals_run_schedule(slam_world):
    """The system's ``MappingProgram`` (capture off: the body a card
    replays as one graph an iteration) against ``run_schedule`` on the same
    draws at ``n_importance = 8``, with BA, TV and the free-space term:
    losses, grids, decoders and cameras bit for bit."""
    _, (dec, grids, bounds, sb), _, _ = slam_world
    colors, depths, cams, valid, fixed = _window(slam_world)
    n_iters = 5
    plan, cfg, pcfg, masks = _pass(grids, n_iters, 1.0, 4)
    masks = {k: torch.from_numpy(m) for k, m in masks.items()}
    colors, depths, cams = (torch.from_numpy(a.copy()) for a in (colors, depths, cams))
    sched = mapper.schedule_arrays(plan, cfg)
    rng = np.random.default_rng(2)
    draws = [tuple(torch.from_numpy(rng.integers(0, hi, 64)) for hi in (3, JINTR.W, JINTR.H))
             for _ in range(n_iters)]
    pp = mapper.make_pass_params(grids, dec, cams, pcfg)
    losses = mapper.run_schedule(pp, mapper.init_opt_state(pp), sched, masks, bounds, sb, INTR,
                                 colors, depths, valid, fixed, pcfg, RCFG,
                                 pixels=dict(enumerate(draws)))
    prog = Programs(capture=False).map_program((4, False, True), "cpu", pcfg, INTR, RCFG,
                                               grids, dec, cams, n_iters)
    g, d, c, lo = prog.run(grids, dec, cams, masks, bounds, sb, colors, depths, valid, fixed,
                           sched, mapper.stack_draws(draws, "cpu"))
    assert torch.equal(lo, losses) and bool(torch.isfinite(lo).all())
    assert torch.equal(c, pp.params["cams"])
    for lvl in grids:
        assert torch.equal(g[lvl], pp.params["grids"][lvl]), lvl
    for a, b in zip(tree_leaves(d), tree_leaves(pp.params["decoders"])):
        assert torch.equal(a, b)
    assert not torch.equal(g["fine"], grids["fine"])  # the pass moved the map
