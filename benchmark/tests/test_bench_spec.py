"""BENCHMARK.json and the files it names: every configuration, traffic mix
and per-layer metric is found by its name."""
import json
import re

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_bench_finds_every_part_by_name():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        conf = spec.config(bench, c["name"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert c["file"].startswith("benchmark/configs/")
    for w in bench["workloads"]:
        assert spec.workload(bench, w["name"]) is w
        spec.traffic(w["traffic"])
        assert w["chips"] == 1
        limits = spec.cell_file(w["name"])["limits"]
        assert {"start_gap", "map_first_gap", "map_loss_gap", "map_change_gap"} <= set(limits)
        assert limits["start_gap"] == 0.0
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_bench_names_and_keys_keep_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(e["name"] == "setup_s" for e in bench["end_to_end"])
    for e in bench["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(bench)) < 64 * 1024


def test_bench_every_cell_reports_setup_another_metric_and_a_layer():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        e2e = [e["name"] for e in spec.metrics_for(bench["end_to_end"], w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench["per_layer"], w["name"])


def test_bench_overrides_refuse_unknown_keys():
    bench = spec.load_benchmark()
    slam = spec.config(bench, "replica_room0")["slam"]
    assert spec.with_overrides(slam, {"tracking.gt_camera": True})["tracking"]["gt_camera"]
    try:
        spec.with_overrides(slam, {"tracking.no_such_key": 1})
    except KeyError:
        pass
    else:
        raise AssertionError("an unknown key was accepted")
