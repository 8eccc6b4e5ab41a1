"""The port's programs (``slam/programs.py``) on the CPU, where they run
their Python body eagerly on the same static buffers that a card replays
as CUDA graphs.

- The mapping iteration with device schedule tables and a device step
  counter equals the host-float loop it replaced, restated here, bit for
  bit (BA, a non-unit ``lr_factor``, padded chunks).
- The static-buffer runners equal fresh passes and solves bit for bit over
  consecutive events with other inputs, and never hand out their buffers.
- The signatures that ``NiceSLAM.precompile`` makes are the JAX package's,
  and it draws nothing from the system's generator.
- Launches counted at a capture are added once per replay.
"""
import os
import types

import numpy as np
import pytest
import torch

from niceslam_tpu.slam.system import NiceSLAM as JNiceSLAM
from niceslam_tpu_torch.config.schema import load_config
from niceslam_tpu_torch.core.pose import tensor_from_camera
from niceslam_tpu_torch.models.decoders import tree_leaves, tree_map
from niceslam_tpu_torch.ops import packed_kernels as pk
from niceslam_tpu_torch.ops import trilerp_kernels as tk
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
    counter it moved (K1 by variant, K2 by gradients, K4), and restoring a
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
        delta = programs.launch_delta(programs.launch_counts(), before)
        programs.restore_counts(before)
        assert tk.LAUNCHES == {"trilerp_fwd": 1, "trilerp_bwd": 0}
        assert not tk.FWD_TALLY and not tk.BWD_TALLY and not any(pk.LAUNCHES.values())
        programs.add_replays(delta, 7)
        assert tk.LAUNCHES == {"trilerp_fwd": 22, "trilerp_bwd": 14}
        assert dict(tk.FWD_TALLY) == {("vector", False, 48000): 21}
        assert dict(tk.BWD_TALLY) == {(True, False): 14}
        assert pk.LAUNCHES == {"corner_table": 0, "gather_rows": 7, "scatter_corners": 0}
    finally:
        programs.restore_counts(saved)
