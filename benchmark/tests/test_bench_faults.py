"""The check catches a broken timed path: a run at a tiny size on the CPU,
the program broken underneath, must come out ``correct: false``. One case
for each fault the cells can have (no cell spans chips, so there is no
exchange to leave out). The altered answer is the mapping pass's grids
shifted by 0.05: a solve's final pose is not compared (``check.py``).
Besides, the schedule the configuration sets: a commit dropped, half the
iterations, bundle adjustment off, mapping events skipped."""
import dataclasses

import pytest
import torch

from niceslam_tpu_torch.slam import mapper, programs, system, tracker

# Keyframes every 5th frame and bundle adjustment from the second: the
# window's cameras move inside a tiny run.
EARLY_BA = {"mapping.keyframe_every": 5, "mapping.BA_min_keyframes": 1}


def _unchanged_pass(monkeypatch):
    run = programs.MappingProgram.run

    def broken(self, grids, decoders, cams, *args):
        _, _, _, losses = run(self, grids, decoders, cams, *args)
        return ({k: v.clone() for k, v in grids.items()}, programs.clone_tree(decoders),
                cams.clone(), losses)

    monkeypatch.setattr(programs.MappingProgram, "run", broken)


def _half_batch(monkeypatch):
    loss = mapper.mapping_loss

    def broken(all_params, bounds, scene_bound, intr, colors, depths, frame_valid, cam_fixed,
               fidx, i, j, *args, **kw):
        h = fidx.shape[0] // 2
        return 2.0 * loss(all_params, bounds, scene_bound, intr, colors, depths, frame_valid,
                          cam_fixed, fidx[:h], i[:h], j[:h], *args, **kw)

    monkeypatch.setattr(mapper, "mapping_loss", broken)


def _half_batch_tracker(monkeypatch):
    step = tracker.gn_step

    def broken(params, grids, bounds, scene_bound, intr, color, depth, init, xi, i, j, *args):
        h = i.shape[0] // 2
        x, loss = step(params, grids, bounds, scene_bound, intr, color, depth, init, xi, i[:h],
                       j[:h], *args)
        return x, 2.0 * loss

    monkeypatch.setattr(tracker, "gn_step", broken)


def _altered_map(monkeypatch):
    run = programs.MappingProgram.run

    def broken(self, *args):
        grids, decoders, cams, losses = run(self, *args)
        return ({k: v + 0.05 for k, v in grids.items()}, decoders, cams, losses)

    monkeypatch.setattr(programs.MappingProgram, "run", broken)


def _dropped_commit(monkeypatch):
    """The pass runs, but the system keeps the map it had: a state left
    unchanged by the system rather than by the pass."""
    run_mapper = system.NiceSLAM._run_mapper

    def broken(self, *args, **kw):
        kept = self.state.grids, self.state.decoders
        out = run_mapper(self, *args, **kw)
        self.state.grids, self.state.decoders = kept
        return out

    monkeypatch.setattr(system.NiceSLAM, "_run_mapper", broken)


def _halved_iters(monkeypatch):
    plan = system.build_stage_plan

    def broken(n, *args, **kw):
        return plan(max(n // 2, 1), *args, **kw)

    monkeypatch.setattr(system, "build_stage_plan", broken)


def _ba_off(monkeypatch):
    """Every pass without bundle adjustment, where the configuration has it."""
    run_mapper = system.NiceSLAM._run_mapper

    def broken(self, *args, **kw):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, BA=False))
        try:
            return run_mapper(self, *args, **kw)
        finally:
            self.cfg = cfg

    monkeypatch.setattr(system.NiceSLAM, "_run_mapper", broken)


def _skipped_events(monkeypatch):
    """Every other mapping event left out."""
    map_frame = system.NiceSLAM.map_frame

    def broken(self, frame, first=False):
        if first or (len(self.est_c2w) - 1) % 10:
            return map_frame(self, frame, first=first)

    monkeypatch.setattr(system.NiceSLAM, "map_frame", broken)


@pytest.mark.parametrize("fault,workload", [
    (_unchanged_pass, "replica.mapping"), (_unchanged_pass, "scannet.slam"),
    (_half_batch, "replica.mapping"), (_half_batch, "scannet.slam"),
    (_half_batch_tracker, "scannet.slam"), (_half_batch_tracker, "replica.slam"),
    (_altered_map, "replica.mapping"), (_altered_map, "scannet.slam"),
    (_altered_map, "replica.slam"),
    (_dropped_commit, "replica.mapping"), (_dropped_commit, "scannet.slam"),
    (_dropped_commit, "replica.slam"),
    (_halved_iters, "replica.mapping"), (_skipped_events, "replica.mapping"),
])
def test_bench_fault_is_caught(tiny_run, monkeypatch, fault, workload):
    fault(monkeypatch)
    line = tiny_run(workload)
    assert "map_change_gap" in line["checks"], "the window held no mapping event"
    assert line["correct"] is False
    assert any(v > lim for v, lim in line["checks"].values())


def test_bench_ba_off_is_caught(tiny_run, monkeypatch):
    _ba_off(monkeypatch)
    line = tiny_run("replica.mapping", sets=EARLY_BA)
    assert line["correct"] is False
    assert line["checks"]["schedule_gap"][0] > 0


def test_bench_dropped_commit_reads_stale(tiny_run, monkeypatch):
    _dropped_commit(monkeypatch)
    line = tiny_run("replica.mapping")
    assert line["checks"]["chain_gap"][0] > 0


@pytest.mark.parametrize("workload,sets", [
    ("scannet.slam", None), ("replica.mapping", EARLY_BA),
])
def test_bench_sound_run_is_correct(tiny_run, workload, sets):
    line = tiny_run(workload, seed=7, sets=sets)
    assert line["correct"] is True
    for name in ("start_gap", "schedule_gap", "window_gap", "chain_gap"):
        assert line["checks"][name] == [0, 0], name


@pytest.mark.card
def test_bench_control_fails_on_the_card(card):
    """The control at the cells' sizes on three seeds (a short window): the
    program passes every limit, the TF32 reference fails one, and so does
    the reference with half of each batch left out."""
    import time

    from benchmark.harness import drive, spec

    for cell in spec.load_benchmark()["workloads"]:
        for seed in (11, 2**31 + 5, 3000000019):
            line = drive.run(cell["name"], seed, 5.0, False, card, time.perf_counter(),
                             control=True, fault=True, log=lambda *a: None)
            assert line["correct"] is True
            limits = {k: lim for k, (_, lim) in line["checks"].items()}
            assert any(v > limits[k] for k, v in line["control"].items())
            assert any(v > limits[k] for k, v in line["half_batch"].items())
            torch.cuda.empty_cache()
