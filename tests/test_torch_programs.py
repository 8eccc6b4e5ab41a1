"""The port's programs (``slam/programs.py``) on the CPU, where they run
their Python body eagerly on the same static buffers that a card replays
as CUDA graphs.

- The mapping iteration with device schedule tables and a device step
  counter equals the host-float loop it replaced, restated here, bit for
  bit (BA, a non-unit ``lr_factor``, padded chunks).
- The static-buffer runners equal fresh passes and solves bit for bit over
  consecutive events with other inputs, and never hand out their buffers.
- The signatures that ``NiceSLAM.precompile`` makes are the JAX package's,
  with the keyframe programs, and it draws nothing from the system's
  generator.
- The stateless programs (keyframe overlap, frustum masks, ``render_image``'s
  chunk, the mesher's chunk) equal the eager functions bit for bit over
  calls with other inputs, and never hand out their buffers.
- Launches counted at a capture are added once per replay.
- Every ``Programs`` captures a card's graphs on the card's one stream into
  its one pool, and no program makes a buffer in a capture (run through
  host stand-ins of ``torch.cuda``'s capture calls).
"""
import contextlib
import gc
import os
import types

import numpy as np
import pytest
import torch

from niceslam_tpu.slam.system import NiceSLAM as JNiceSLAM
from niceslam_tpu_torch.config.schema import load_config
from niceslam_tpu_torch.core import rays as rays_mod
from niceslam_tpu_torch.core.pose import tensor_from_camera
from niceslam_tpu_torch.eval import mesher
from niceslam_tpu_torch.models.decoders import nice_forward, tree_leaves, tree_map
from niceslam_tpu_torch.ops import decoder_kernels as dk
from niceslam_tpu_torch.ops import packed_kernels as pk
from niceslam_tpu_torch.ops import trilerp_kernels as tk
from niceslam_tpu_torch.render.renderer import render_image, render_rays
from niceslam_tpu_torch.slam import keyframes as kf_mod
from niceslam_tpu_torch.slam import mapper, programs
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.slam.tracker import TrackConfig, track_frame

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "cofusion.yaml")
TINY = {"dataset": "synthetic", "cam.H": 24, "cam.W": 32, "cam.fx": 24.0, "cam.fy": 24.0,
        "cam.cx": 16.0, "cam.cy": 12.0, "mapping.pixels": 48, "mapping.iters": 6,
        "mapping.iters_first": 8, "tracking.pixels": 40, "tracking.iters": 3,
        "tracking.ignore_edge_H": 2, "tracking.ignore_edge_W": 2, "verbose": False}
N_PIX = 48


def _slam(**overrides):
    return NiceSLAM(load_config(CONFIG, overrides={**TINY, **overrides}), device="cpu")


@pytest.fixture(scope="module")
def world():
    """A tiny system's initial map (random grids, the shipped decoders) and
    four frames of the synthetic scene at their true poses."""
    slam = _slam()
    frames = [slam.reader[k] for k in range(4)]
    return slam, frames


def _window(slam, frames, order, valid, fixed):
    F = len(order)
    colors = torch.stack([torch.from_numpy(frames[k].color) for k in order])
    depths = torch.stack([torch.from_numpy(frames[k].depth) for k in order])
    cams = tensor_from_camera(torch.from_numpy(np.stack([frames[k].gt_c2w for k in order])))
    return colors, depths, cams, np.asarray(valid[:F], bool), np.asarray(fixed[:F], bool)


def _pass(slam, lr_factor, iters=6, ba=True):
    m = slam.cfg.mapping
    plan = mapper.build_stage_plan(iters, m.middle_iter_ratio, m.fine_iter_ratio, m.stage_lr)
    mcfg = mapper.MapOptConfig(pixels=N_PIX, BA=ba, lr_factor=lr_factor,
                               train_all_decoders=True, fs_weight=3.0)
    pcfg = mapper.ProgConfig(n_pixels=N_PIX, w_color_loss=mcfg.w_color_loss, frustum=True,
                             dec_train=mapper.dec_train_from_plan(plan, mcfg), ba=ba,
                             fs_weight=3.0)
    return plan, mcfg, pcfg


def _masks(grids, seed):
    rng = np.random.default_rng(seed)
    return {lvl: torch.from_numpy((rng.uniform(size=g.shape[:3] + (1,)) > 0.3)
                                  .astype(np.float32)) for lvl, g in grids.items()}


def _draws(rows, valid, seed, intr):
    rng = np.random.default_rng(seed)
    slots = np.flatnonzero(valid)
    return torch.from_numpy(np.stack([
        np.stack([rng.choice(slots, N_PIX), rng.integers(0, intr.W, N_PIX),
                  rng.integers(0, intr.H, N_PIX)]) for _ in range(rows)]))


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------- (a)
def _host_float_adam_update(pp, grads, state, lr_grids, lr_dec, lr_cam, masks):
    """The mapper's Adam step as it was before the tables: learning rates
    and bias corrections as host floats."""
    state.count += 1
    for p, g, mu, nu, (kind, lvl) in zip(pp.leaves, grads, state.mu, state.nu, pp.groups):
        mapper.adam_moments_(mu, nu, g)
        if kind == "grids":
            lr = float(lr_grids[mapper.LEVEL_ORDER.index(lvl)])
        elif kind == "decoders":
            lr = float(lr_dec[mapper.LEVEL_ORDER.index(lvl)])
        else:
            lr = float(lr_cam)
        if lr == 0.0:
            continue
        k = np.float32(state.count)
        bc1 = float(np.float32(1.0) - np.float32(mapper.ADAM_B1) ** k)
        bc2 = float(np.float32(1.0) - np.float32(mapper.ADAM_B2) ** k)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + mapper.ADAM_EPS)
        if kind == "grids" and masks is not None:
            upd = upd * masks[lvl]
        p.sub_(lr * upd)


def _host_float_run_schedule(pp, opt, sched, masks, bounds, sb, intr, colors, depths, valid,
                             fixed, pcfg, rcfg, pixels):
    """``run_schedule`` as it was before the tables: one host loop over the
    rows, learning rates read on the host row by row."""
    valid_t, fixed_t = torch.from_numpy(valid), torch.from_numpy(fixed)
    masks = masks if pcfg.frustum else None
    losses = []
    for r in range(len(sched)):
        if not sched.active[r]:
            losses.append(torch.zeros(()))
            continue
        fidx, i, j = pixels[int(sched.iter_idx[r])]
        loss = mapper.mapping_loss(
            pp.params, bounds, sb, intr, colors, depths, valid_t, fixed_t, fidx, i, j,
            mapper.STAGE_ORDER[int(sched.stage_ids[r])], pcfg.w_color_loss, rcfg,
            tv_weight=pcfg.tv_weight, fs_weight=pcfg.fs_weight, fs_band=pcfg.fs_band)
        grads = list(torch.autograd.grad(loss, pp.leaves, allow_unused=True))
        with torch.no_grad():
            _host_float_adam_update(pp, grads, opt, sched.lr_grids[r], sched.lr_dec[r],
                                    sched.lr_cam[r], masks)
        losses.append(loss.detach())
    return torch.stack(losses)


def test_mapping_iteration_equals_the_host_float_loop(world):
    """Chunks of 4 rows (the last padded) of a 6-iteration pass with BA,
    every decoder trained and ``lr_factor`` 2.5: ``run_schedule`` over the
    device tables equals the host-float loop in every loss, parameter and
    moment, bit for bit."""
    slam, frames = world
    plan, mcfg, pcfg = _pass(slam, 2.5)
    colors, depths, cams, valid, fixed = _window(slam, frames, [0, 1, 2, 3], [1, 1, 1, 0],
                                                 [1, 0, 0, 1])
    masks = _masks(slam.state.grids, 1)
    draws = _draws(6, valid, 2, slam.intr)
    pixels = {it: tuple(draws[it]) for it in range(6)}
    chunks, reals = mapper.chunked_schedule(plan, mcfg, 4)
    assert reals == (4, 2)
    out = []
    for run in (mapper.run_schedule, _host_float_run_schedule):
        pp = mapper.make_pass_params(slam.state.grids, slam.state.decoders, cams, pcfg)
        opt = mapper.init_opt_state(pp)
        losses = torch.cat([run(pp, opt, c, masks, slam.bounds, slam.scene_bound, slam.intr,
                                colors, depths, valid, fixed, pcfg, slam.rcfg, pixels=pixels)
                            for c in chunks])
        out.append((losses, pp, opt))
    (l1, pp1, o1), (l2, pp2, o2) = out
    assert bool(torch.isfinite(l1).all()) and torch.equal(l1, l2)
    assert o1.count == o2.count == 6
    assert _equal_trees(pp1.params, pp2.params)
    assert _equal_trees(o1.mu + o1.nu, o2.mu + o2.nu)
    assert not torch.equal(pp1.params["cams"], cams)  # BA moved the free poses


def test_adam_direction_keeps_the_host_float_bits():
    """A bias-correction table entry gives the bits of dividing by the
    correction as a host float, at counts 1 to 1500 (the CPU's form)."""
    rng = np.random.default_rng(0)
    mu = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    nu = torch.from_numpy(rng.uniform(size=4096).astype(np.float32))
    c1, c2 = mapper.bias_corrections(1500, "cpu")
    for count in (1, 2, 3, 10, 60, 61, 1500):
        k = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(mapper.ADAM_B1) ** k)
        bc2 = float(np.float32(1.0) - np.float32(mapper.ADAM_B2) ** k)
        want = (mu / bc1) / (torch.sqrt(nu / bc2) + mapper.ADAM_EPS)
        got = mapper.adam_direction(mu, nu, c1[count - 1:count], c2[count - 1:count])
        assert torch.equal(got, want), count
    r1, r2 = mapper.bias_corrections(3, "cpu", start=59)
    assert torch.equal(r1, c1[59:62]) and torch.equal(r2, c2[59:62])


# ---------------------------------------------------------------- (b)
def test_mapping_program_equals_fresh_passes_over_two_events(world):
    """Two events through one program's buffers, with other frames, window
    validity, pinned poses, masks, ``lr_factor`` and row count (the tables
    grow), each equal to a fresh pass bit for bit; the first event's
    outputs and every input stay as they were."""
    slam, frames = world
    progs = programs.Programs(capture=False)
    events = [
        ([0, 1, 2, 3], [1, 1, 1, 0], [1, 0, 0, 1], 1.0, 6, 3),
        ([2, 3, 1, 0], [1, 1, 0, 0], [1, 0, 1, 1], 3.0, 8, 4),
    ]
    grids, decoders = slam.state.grids, slam.state.decoders
    kept = []
    for order, valid, fixed, lr_factor, iters, seed in events:
        plan, mcfg, pcfg = _pass(slam, lr_factor, iters)
        colors, depths, cams, valid, fixed = _window(slam, frames, order, valid, fixed)
        masks = _masks(grids, seed)
        sched = mapper.schedule_arrays(plan, mcfg)
        draws = _draws(len(sched), valid, seed, slam.intr)
        before = tree_map(torch.clone, (grids, decoders, cams, masks))

        pp = mapper.make_pass_params(grids, decoders, cams, pcfg)
        want_losses = mapper.run_schedule(
            pp, mapper.init_opt_state(pp), sched, masks, slam.bounds, slam.scene_bound,
            slam.intr, colors, depths, valid, fixed, pcfg, slam.rcfg,
            pixels={it: tuple(draws[it]) for it in range(len(sched))})
        prog = progs.map_program((4, False, True), "cpu", pcfg, slam.intr, slam.rcfg, grids,
                                 decoders, cams, rows=6)
        got = prog.run(grids, decoders, cams, masks, slam.bounds, slam.scene_bound, colors,
                       depths, valid, fixed, sched, draws)
        assert torch.equal(got[3], want_losses)
        assert _equal_trees(got[:3], (pp.params["grids"], pp.params["decoders"],
                                      pp.params["cams"]))
        assert _equal_trees((grids, decoders, cams, masks), before)
        kept.append((got, tree_map(torch.clone, got)))
        grids, decoders = got[0], got[1]
    assert len(progs.mapping) == 1 and prog.tab.lrs.shape[0] == 8
    got, copy = kept[0]
    assert _equal_trees(got, copy)  # the buffers were not handed out
    assert not any(any(t.data_ptr() == b.data_ptr() for b in tree_leaves(prog.pp.params))
                   for t in tree_leaves(kept[1][0]))


# ---------------------------------------------------------------- (c)
@pytest.mark.parametrize("method", ["gn", "adam"])
def test_track_program_equals_track_frame(world, method):
    """Two solves through one program's buffers (another frame, warm start
    and map for the second) equal ``track_frame`` bit for bit."""
    slam, frames = world
    cfg = TrackConfig(pixels=40, iters=3, ignore_edge_H=2, ignore_edge_W=2, method=method,
                      separate_LR=True, gn_depth_offset_sigma=0.05)
    prog = programs.Programs(capture=False).track_program(
        "cpu", cfg, slam.intr, slam.rcfg, slam.state.decoders, slam.state.grids)
    rng = np.random.default_rng(5)
    grids = slam.state.grids
    for k in (1, 2):
        color, depth = (torch.from_numpy(a) for a in (frames[k].color, frames[k].depth))
        init = torch.from_numpy(frames[k - 1].gt_c2w.astype(np.float32))
        pixels = [(torch.from_numpy(rng.integers(2, slam.intr.W - 2, 40)),
                   torch.from_numpy(rng.integers(2, slam.intr.H - 2, 40))) for _ in range(3)]
        want = track_frame(slam.state.decoders, grids, slam.bounds, slam.scene_bound,
                           slam.intr, color, depth, init, cfg, slam.rcfg, pixels=pixels)
        got = prog.run(slam.state.decoders, grids, slam.bounds, slam.scene_bound, color, depth,
                       init, mapper.stack_draws(pixels, "cpu"))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float((got[0] - init).abs().max()) > 0  # the solve moved
        grids = {lvl: g + 0.01 for lvl, g in grids.items()}


# ---------------------------------------------------------------- (d), (e)
@pytest.mark.parametrize("ba,refine", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_precompile_makes_the_jax_signatures_and_draws_nothing(ba, refine):
    """``_precompile_signatures`` equals the JAX package's for BA x
    ``color_refine``; ``precompile`` makes one mapping program per signature
    (and the tracker's) and leaves ``self.gen`` where it was."""
    slam = _slam(**{"mapping.BA": ba, "mapping.color_refine": refine})
    m = slam.cfg.mapping
    jself = types.SimpleNamespace(cfg=types.SimpleNamespace(mapping=types.SimpleNamespace(
        mapping_window_size=m.mapping_window_size, BA=m.BA, color_refine=m.color_refine)))
    sigs = slam._precompile_signatures()
    assert sigs == JNiceSLAM._precompile_signatures(jself)
    state = slam.gen.get_state()
    slam.precompile()
    assert torch.equal(slam.gen.get_state(), state)
    assert sorted(p.signature for p in slam._programs.mapping.values()) == sorted(sigs)
    assert len(slam._programs.tracking) == 1 and not slam._programs.captures
    # The overlap over the keyframe capacity, the frustum masks per window
    # size of the passes that select features (refinement does not).
    static = sorted((k[0].split()[0], k[4][0][0]) for k in slam._programs.static)
    K = slam.state.keyframes.capacity
    assert static == [("frustum_masks", (m.mapping_window_size, 4, 4)),
                      ("keyframe_overlap", (4, 4))]
    assert any(k[0] == f"keyframe_overlap K={K}" for k in slam._programs.static)


def test_precompile_leaves_the_trajectory_as_it_was():
    """Three frames with BA and color refinement on, with and without
    ``precompile``: the same poses and grids bit for bit."""
    runs = []
    for pre in (False, True):
        slam = _slam()
        if pre:
            slam.precompile()
        res = slam.run(3)
        runs.append((np.stack(res["est_c2w"]), slam.state.grids))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert _equal_trees(runs[0][1], runs[1][1])


def test_tracker_role_with_retrack_equals_the_plain_run():
    """``parallel.track_role`` on ``[cpu, cpu]`` with ``mapping.retrack``:
    the event frame's re-track solves on the main device against the fresh
    map (not the role's copy of the map before the event), so poses and
    grids equal the plain run's bit for bit."""
    runs = []
    for role in (False, True):
        cfg = load_config(CONFIG, overrides={**TINY, "parallel.track_role": role,
                                             "mapping.retrack": True})
        slam = NiceSLAM(cfg, devices=["cpu", "cpu"])
        res = slam.run(6)
        runs.append((np.stack(res["est_c2w"]), slam.state.grids))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert _equal_trees(runs[0][1], runs[1][1])


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="capture=True needs CUDA devices"):
        NiceSLAM(load_config(CONFIG, overrides=TINY), device="cpu", capture=True)
    assert not NiceSLAM(load_config(CONFIG, overrides=TINY), device="cpu")._programs.capture


# ------------------------------------------------------------ launch counts
def test_replays_add_the_launches_their_capture_counted():
    """A capture's launch delta, added for 7 replays, gives 7 times every
    counter it moved (K1 by variant, K2 by gradients, K4, K6 by tangents),
    and restoring a
    reading takes out what was counted after it."""
    saved = programs.launch_counts()
    try:
        tk.reset_launches()
        pk.reset_launches()
        tk.LAUNCHES["trilerp_fwd"] += 1
        before = programs.launch_counts()
        tk.LAUNCHES["trilerp_fwd"] += 3
        tk.FWD_TALLY["vector", False, 48000] += 3
        tk.LAUNCHES["trilerp_bwd"] += 2
        tk.BWD_TALLY[True, False] += 2
        pk.LAUNCHES["gather_rows"] += 1
        dk.LAUNCHES["decoder_jvp"] += 3
        dk.JVP_TALLY[6, 48000] += 3
        delta = programs.launch_delta(programs.launch_counts(), before)
        programs.restore_counts(before)
        assert tk.LAUNCHES == {"trilerp_fwd": 1, "trilerp_bwd": 0}
        assert not tk.FWD_TALLY and not tk.BWD_TALLY and not any(pk.LAUNCHES.values())
        assert dk.LAUNCHES == {"decoder_jvp": 0} and not dk.JVP_TALLY
        programs.add_replays(delta, 7)
        assert tk.LAUNCHES == {"trilerp_fwd": 22, "trilerp_bwd": 14}
        assert dict(tk.FWD_TALLY) == {("vector", False, 48000): 21}
        assert dict(tk.BWD_TALLY) == {(True, False): 14}
        assert pk.LAUNCHES == {"corner_table": 0, "gather_rows": 7, "scatter_corners": 0}
        assert dk.LAUNCHES == {"decoder_jvp": 21} and dict(dk.JVP_TALLY) == {(6, 48000): 21}
    finally:
        programs.restore_counts(saved)


# ---------------------------------------------------------------- (f)
def _static_buffers(progs):
    return [t.data_ptr() for p in progs.static.values()
            for t in tree_leaves((p.fixed, p.args, p.out))]


def test_keyframe_programs_equal_the_eager_functions(world):
    """Two mapping events' overlap and frustum masks (other poses, depths,
    validity and pixels) through one system's programs equal the eager
    functions bit for bit; their results are new tensors."""
    slam, frames = world
    progs = programs.Programs(capture=False)
    rng = np.random.default_rng(6)
    wide = rays_mod.Intrinsics(H=96, W=128, fx=96.0, fy=96.0, cx=64.0, cy=48.0)
    kf = torch.from_numpy(np.stack([frames[k % 4].gt_c2w for k in range(
        slam.state.keyframes.capacity)]).astype(np.float32))
    kept = []
    for order, valid in (([0, 1, 2, 3], [1, 1, 1, 0]), ([3, 1, 0, 2], [1, 0, 1, 1])):
        _, depths, _, valid, _ = _window(slam, frames, order, valid, [0] * 4)
        poses = torch.from_numpy(np.stack([frames[k].gt_c2w for k in order]).astype(np.float32))
        valid = torch.from_numpy(valid)
        want = kf_mod.frustum_masks_for_levels(poses, valid, depths, slam.intr,
                                               slam._bounds_host, slam.state.grids)
        got = progs.frustum_masks(poses, valid, depths, slam.intr, slam._bounds_host,
                                  slam.state.grids)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        assert any(0 < float(m.sum()) < m.numel() for m in got.values())
        # The overlap on a 96 x 128 image: the tiny world's is inside the
        # 20-pixel edge that the score leaves out.
        depth = torch.from_numpy(rng.uniform(0.5, 3.0, (wide.H, wide.W)).astype(np.float32))
        depth[:8] = 0.0
        color = torch.from_numpy(rng.uniform(size=(wide.H, wide.W, 3)).astype(np.float32))
        i = torch.from_numpy(rng.integers(0, wide.W, kf_mod.OVERLAP_PIXELS))
        j = torch.from_numpy(rng.integers(0, wide.H, kf_mod.OVERLAP_PIXELS))
        want_pct = kf_mod.keyframe_overlap_percentages(wide, poses[0], depth, color, kf, i, j)
        got_pct = progs.overlap_percentages(wide, poses[0], depth, color, kf, i, j)
        assert torch.equal(got_pct, want_pct) and float(got_pct.max()) > 0
        kept.append((got, got_pct, tree_map(torch.clone, (got, got_pct))))
    assert len(progs.static) == 2
    ptrs = set(_static_buffers(progs))
    assert not any(t.data_ptr() in ptrs for t in tree_leaves([k[:2] for k in kept]))
    assert _equal_trees(kept[0][:2], kept[0][2])


@pytest.mark.parametrize("with_depth", [True, False])
def test_render_program_equals_the_chunk_loop(world, with_depth):
    """``render_image`` (its chunk program, capture off) equals the loop of
    ``render_rays`` over row chunks it replaced, bit for bit, at H = 24 in
    chunks of 5 rows (padded), for two poses and maps through one program."""
    slam, frames = world
    progs = programs.Programs(capture=False)
    grids = slam.state.grids
    for k in (1, 2):
        c2w = torch.from_numpy(frames[k].gt_c2w.astype(np.float32))
        depth = torch.from_numpy(frames[k].depth) if with_depth else None
        args = (slam.state.decoders, grids, slam.bounds, slam.scene_bound, slam.intr, c2w,
                depth, "color", slam.rcfg, 5)
        got = render_image(*args, programs=progs)
        want = _loop_render_image(*args)
        for name in ("rgb", "depth", "depth_var", "weights"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert float(got.depth.max()) > 0
        grids = {lvl: g + 0.01 for lvl, g in grids.items()}
    assert len(progs.static) == 1
    with pytest.raises(ValueError, match="perturb"):
        render_image(*args[:8], slam.rcfg._replace(perturb=1.0), programs=progs)


def _loop_render_image(params, grids, bounds, scene_bound, intr, c2w, gt_depth, stage, cfg,
                       rows):
    """``render_image`` as it was before its program: ``render_rays`` on
    each row chunk of the padded image, then cropped."""
    H, W = intr.H, intr.W
    pad, n = (-H) % rows, rows * W
    with torch.no_grad():
        ro, rd = rays_mod.rays_for_image(intr, c2w)
        ro = torch.cat([ro, ro[-1:].expand(pad, W, 3)], 0).reshape(-1, n, 3)
        rd = torch.cat([rd, rd[-1:].expand(pad, W, 3)], 0).reshape(-1, n, 3)
        gd = (None if gt_depth is None
              else torch.cat([gt_depth, gt_depth[-1:].expand(pad, W)], 0).reshape(-1, n))
        outs = [render_rays(params, grids, bounds, scene_bound, ro[k], rd[k],
                            None if gd is None else gd[k], stage, cfg)
                for k in range(ro.shape[0])]
    cat = lambda name, *shape: torch.cat([getattr(o, name) for o in outs]).reshape(  # noqa: E731
        H + pad, W, *shape)[:H]
    return types.SimpleNamespace(rgb=cat("rgb", 3), depth=cat("depth"),
                                 depth_var=cat("depth_var"), weights=cat("weights", -1))


def test_mesher_programs_equal_the_chunk_loop(world):
    """The occupancy query (fine stage) and the vertex colours (color
    stage) through their chunk programs (capture off) equal ``nice_forward``
    over the same padded chunks, bit for bit, on two maps."""
    slam, _ = world
    progs = programs.Programs(capture=False)
    grids = slam.state.grids
    pts = mesher.lattice_points(slam.scene_bound, 12).reshape(-1, 3)  # 1728 points
    for _ in range(2):
        for stage, output, cols in (("fine", "occupancy", 3), ("color", "rgb", slice(0, 3))):
            got = mesher.query_chunks(slam.state.decoders, grids, slam.bounds, pts, 500,
                                       stage, output, programs=progs)
            flat = torch.from_numpy(np.concatenate([pts, np.zeros((272, 3), np.float32)]))
            with torch.no_grad():
                want = torch.cat([nice_forward(slam.state.decoders, grids, flat[i:i + 500],
                                               slam.bounds, stage)[:, cols]
                                  for i in range(0, 2000, 500)]).numpy()[:len(pts)]
            assert got.shape == want.shape and np.array_equal(got, want), stage
        grids = {lvl: g + 0.01 for lvl, g in grids.items()}
    assert len(progs.static) == 2


# ------------------------------------------------------- one pool per card
class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: replays nothing."""

    def __init__(self, keep_graph=False):
        pass

    def instantiate(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda``'s capture calls as host stand-ins, so that
    ``Programs.capture_graph`` runs its warm-up and its capture (each one
    call of the body) on the CPU; a capture's replay does nothing. Returns
    the ``(pool, stream)`` of every capture, in order."""
    seen = []
    handles = iter(range(1, 10**6))

    class _Graph:
        def __init__(self, graph, pool, stream, capture_error_mode):
            seen.append((pool, stream))

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    nullctx = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
    monkeypatch.setattr(programs, "_CARDS", {})
    monkeypatch.setattr(programs, "graph_nodes", lambda graph: 0)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "device", nullctx)
    monkeypatch.setattr(torch.cuda, "stream", nullctx)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return seen


def test_every_programs_object_of_a_card_shares_its_stream_and_pool(fake_card):
    """Captures by two ``Programs`` on one card get the card's one stream
    and pool; another card has its own. The warm-up's writes are undone.
    The pool lives while one of its graphs does: once none is left, the
    next capture opens a new one."""
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    buf = torch.zeros(3)

    def body():
        buf.add_(1.0)

    kept = [programs.Programs(capture=True).capture_graph(dev, "add", body, lambda: [buf])
            for dev in (card0, card0, card1)]
    assert torch.equal(buf, torch.zeros(3))
    (pool0, stream0), (pool0b, stream0b), (pool1, stream1) = fake_card
    assert (pool0b, stream0b) == (pool0, stream0) and pool1 != pool0 and stream1 is not stream0
    assert programs.card_graphs(card0).stream is stream0
    assert len(programs.card_graphs(card0).graphs) == 2
    del kept[:2]
    gc.collect()
    programs.Programs(capture=True).capture_graph(card0, "add", body, lambda: [buf])
    assert fake_card[-1][0] != pool0 and fake_card[-1][1] is stream0
    assert programs.card_graphs(card0).pools == [pool0, fake_card[-1][0]]


def test_a_capture_that_makes_a_buffer_raises(fake_card):
    """A body that makes its output anew at every call would leave it in
    the card's shared pool: the capture raises."""
    out = {}

    def body():
        out["t"] = torch.ones(2)

    with pytest.raises(RuntimeError, match="made in the capture"):
        programs.Programs(capture=True).capture_graph(
            torch.device("cuda", 0), "fresh output", body, lambda: list(out.values()))


def test_map_program_captures_every_segment_into_the_card_pool(fake_card):
    """A system on each rank of a 2 x 1 mesh (no process group: a
    collective would raise) precompiled with capture on, through the host
    stand-ins: each stage's map-sharded iteration is four captures (halo
    rows, local samples, loss and gradients, returned gradients and the
    step), on the card's one stream into its one pool, on the rank's Z
    blocks; no capture makes a buffer or issues a collective, and the
    warm-ups leave the map and the generator as they were. The first block
    keeps ``cat(block, halo)`` in a buffer of its own; the last reads its
    block alone."""
    from niceslam_tpu_torch.parallel.mesh import CALLS, MapKfMesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime

    segments = ["halo", "sample", "grads", "gather+step"]
    for map_i in (0, 1):
        system = _slam(**{"parallel.n_processes": 2, "parallel.map": 2})
        rt = MapKfRuntime(MapKfMesh(2, 1, map_i, 0), "cpu", None)
        rt.attach(system)
        system._programs = progs = programs.Programs(capture=True)
        before = tree_map(torch.clone, (system.state.grids, system.state.decoders))
        state, calls = system.gen.get_state(), CALLS["all_reduce"]
        system.precompile()
        assert CALLS["all_reduce"] == calls
        assert _equal_trees((system.state.grids, system.state.decoders), before)
        assert torch.equal(system.gen.get_state(), state)
        maps = [c.signature.split(" route=")[0].split() for c in progs.captures
                if c.signature.startswith("map ")]
        assert all(sig[-3:-1] == ["map=2x1", f"rank={map_i},0"] for sig in maps)
        by_stage = {}
        for sig in maps:
            by_stage.setdefault(tuple(sig[:5]), []).append(sig[-1])
        assert by_stage and all(segs == segments for segs in by_stage.values())
        for prog in progs.mapping.values():
            seg = prog.segments
            blocks = prog.pp.params["grids"]
            assert all(blocks[lvl].shape[0] * 2 == g.shape[0]
                       for lvl, g in system.state.grids.items())
            assert all(any(t is b for t in prog.buffers()) for b in seg.buffers())
            assert set(prog.graphs) <= set(seg.layouts)
            assert all((s.local is not None) == (map_i == 0) for s in seg.samplers.values())
        assert len(fake_card) == len(progs.captures) and len(set(fake_card)) == 1
        fake_card.clear()


def test_every_program_makes_its_buffers_before_its_capture(world, fake_card):
    """Every program kind captured through the host stand-ins (a capture
    that made a buffer would raise): a system's precompiled mapping, solve
    and keyframe programs, the ``render_image`` chunk, the mesher's chunks
    and a pretraining step; each captures on the card's one stream into
    its one pool, and the warm-ups leave the map as it was."""
    from niceslam_tpu_torch import pretrain_decoders as pd
    from niceslam_tpu_torch.grid.hierarchy import init_grids

    slam, frames = world
    system = _slam()
    system._programs = progs = programs.Programs(capture=True)
    before = tree_map(torch.clone, (system.state.grids, system.state.decoders))
    system.precompile()
    assert _equal_trees((system.state.grids, system.state.decoders), before)
    c2w = torch.from_numpy(frames[1].gt_c2w.astype(np.float32))
    render_image(slam.state.decoders, slam.state.grids, slam.bounds, slam.scene_bound,
                 slam.intr, c2w, None, "color", slam.rcfg, 5, programs=progs)
    pts = mesher.lattice_points(slam.scene_bound, 8).reshape(-1, 3)
    mesher.query_chunks(slam.state.decoders, slam.state.grids, slam.bounds, pts, 200, "fine",
                        "occupancy", programs=progs)
    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[0], np.float32), device="cpu")
    geom = {k: torch.from_numpy(v) for k, v in
            pd.scene_geometry(np.random.default_rng(0), adj).items()}
    dec = pd.trainable(slam.state.decoders)
    pd.scene_program(progs, dec, pd.trainable(grids), geom, bounds,
                     pd.PretrainConfig(steps=2, batch=64)).warm(dec, grids, geom, bounds)
    kinds = {c.signature.split()[0] for c in progs.captures}
    assert kinds == {"map", "track", "keyframe_overlap", "frustum_masks", "render_chunk",
                     "mesher_chunk", "pretrain"}
    assert len(fake_card) == len(progs.captures) and len(set(fake_card)) == 1


def test_kf_program_captures_both_halves_into_the_card_pool(fake_card, tmp_path):
    """A system on a 1 x 2 mesh (no process group: a collective would
    raise) precompiled with capture on, through the host stand-ins: each
    stage's kf-sharded iteration is two captures, its gradients into the
    flat buffer and its Adam step, all on the card's one stream into its
    one pool; no capture makes a buffer (it would raise), none issues a
    collective, and the warm-ups leave the map and the generator as they
    were. A restore of a snapshot padded for another map extent gives the
    grids other shapes: the programs are made and captured anew for
    them."""
    from niceslam_tpu_torch.parallel.mesh import MapKfMesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.parallel.sharded_mapper import pad_grid_for_sharding
    from niceslam_tpu_torch.utils.checkpoint import save_checkpoint

    system = _slam(**{"parallel.n_processes": 2})
    MapKfRuntime(MapKfMesh(1, 2, 0, 0), "cpu", None).attach(system)
    system._programs = progs = programs.Programs(capture=True)
    before = tree_map(torch.clone, (system.state.grids, system.state.decoders))
    state = system.gen.get_state()
    system.precompile()
    assert _equal_trees((system.state.grids, system.state.decoders), before)
    assert torch.equal(system.gen.get_state(), state)
    maps = [c.signature for c in progs.captures if c.signature.startswith("map ")]
    halves = {" ".join(w for w in sig.split() if not w.startswith("kf=")) for sig in maps}
    grads = {sig.replace(" grads ", " ") for sig in halves if " grads " in sig}
    steps = {sig.replace(" step ", " ") for sig in halves if " step " in sig}
    assert grads and grads == steps and len(maps) == 2 * len(grads)
    assert all(" kf=1,2,0,0 " in sig for sig in maps)
    for prog in progs.mapping.values():
        assert prog.split and any(t is prog.flat for t in prog.buffers())
        assert set(prog.layouts) == {k for k in prog.graphs}
    assert len(fake_card) == len(progs.captures) and len(set(fake_card)) == 1

    shapes = {lvl: g.shape for lvl, g in system.state.grids.items()}
    padded = {lvl: pad_grid_for_sharding(g, system.bounds[lvl], 8)
              for lvl, g in system.state.grids.items()}
    assert any(padded[lvl][0].shape != shapes[lvl] for lvl in shapes)
    system.state.grids = {lvl: g for lvl, (g, _) in padded.items()}
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, system.state, [np.eye(4, dtype=np.float32)], [None], 0,
                    bounds={lvl: b for lvl, (_, b) in padded.items()},
                    scene_bound=system.scene_bound)
    n_maps, n_tracks, n_captures = len(progs.mapping), len(progs.tracking), len(progs.captures)
    system.restore(ck)
    system.precompile()
    assert len(progs.mapping) == 2 * n_maps and len(progs.tracking) == 2 * n_tracks
    assert len(progs.captures) > n_captures
