"""The model-family seam: a configuration names its family, the family file
brings the check's reference and the yardstick, and a new family goes in as
a new file with no harness file touched."""
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import costs, drive, spec


class _Clock:
    """``time`` for ``drive``: every reading 0.125 s (exact in binary) after
    the last, so that a window of a given length holds the same frames in
    every run."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.125
        return self.t


def _configs_of_family(monkeypatch, tmp_path, family):
    """``BENCHMARK.json`` with each configuration's file a temporary copy
    that names ``family``."""
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        conf["family"] = family
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(conf))
        c["file"] = str(path)
    monkeypatch.setattr(spec, "load_benchmark", lambda: bench)


@pytest.mark.parametrize("workload", ["scannet.slam", "replica.mapping"])
def test_bench_named_nice_family_checks_equal_the_default(tiny_run, monkeypatch, tmp_path,
                                                          workload):
    monkeypatch.setattr(drive, "time", _Clock())
    default = tiny_run(workload, seconds=2.5)
    assert "map_change_gap" in default["checks"], "the window held no mapping event"
    assert default["correct"] is True
    _configs_of_family(monkeypatch, tmp_path, "nice")
    monkeypatch.setattr(drive, "time", _Clock())
    named = tiny_run(workload, seconds=2.5)
    assert named["attempted"] == default["attempted"]
    assert named["checks"] == default["checks"]


def test_bench_a_new_family_is_a_new_file(tiny_run, monkeypatch, tmp_path):
    families = tmp_path / "families"
    families.mkdir()
    (families / "stub.py").write_text(
        '"""NICE-SLAM under another name."""\n'
        "from benchmark.families.nice import *  # noqa: F401,F403\n")
    monkeypatch.setattr(spec, "FAMILIES", families)
    _configs_of_family(monkeypatch, tmp_path, "stub")
    # Only the stub is there to be found.
    with pytest.raises(KeyError):
        spec.family("nice")
    line = tiny_run("scannet.slam")
    assert "map_change_gap" in line["checks"] and "track_loss_gap" in line["checks"]
    assert line["correct"] is True


def test_bench_unknown_family_names_the_known_ones():
    with pytest.raises(KeyError, match="'nice'"):
        spec.family("imap")
    with pytest.raises(KeyError, match="'nice'"):
        spec.config_family({"family": "../harness/costs"})


@pytest.mark.parametrize("config", ["scannet_scene0000", "replica_room0"])
def test_bench_nice_family_costs_are_the_yardsticks(config):
    cfg = spec.config(spec.load_benchmark(), config)
    fam = spec.config_family(cfg)
    cfg = cfg["slam"]
    gb = costs.grid_bytes(cfg)
    assert fam.costs.grid_bytes(cfg) == gb
    rows = ([("coarse", False)] * 60 + [("middle", False)] * 25 + [("fine", False)] * 12
            + [("color", True)] * 23)
    stages = [s for s, _ in rows]
    assert fam.costs.window_work(cfg, 7, stages, gb) == costs.window_work(cfg, 7, stages, gb)
    assert fam.costs.sampler_bytes(cfg, 7, rows, gb) == costs.sampler_bytes(cfg, 7, rows, gb)


def test_bench_sampler_roofline_is_silent_without_a_sampler():
    ctx = SimpleNamespace(
        trace={"kernels": {"trilerp_fwd_kernel": 1e-3}}, device=torch.device("cuda"),
        device_name="NVIDIA H100 80GB HBM3", config={}, grid_bytes={},
        cycle=SimpleNamespace(solves=1, rows=[]), log=lambda *a: None,
        costs=SimpleNamespace(sampler_bytes=lambda *a: None, peaks_for=costs.peaks_for))
    assert spec.metric_reader("sampler_roofline")(ctx) is None
    ctx.costs = costs
    ctx.config = {"rendering": {"N_samples": 32, "N_surface": 16}, "model": {"c_dim": 32},
                  "tracking": {"pixels": 10, "iters": 2}, "mapping": {"pixels": 20}}
    assert spec.metric_reader("sampler_roofline")(ctx) > 0
