"""A whole run of each cell at a tiny size on the CPU: the result line has
the keys the driver reads, ``checks`` last, and the cell's metrics."""
import json

import pytest

from benchmark.harness import spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["scannet.slam", "replica.mapping", "replica.slam"])
@pytest.mark.parametrize("trace", [False, True])
def test_bench_line_keys(tiny_run, workload, trace):
    line = tiny_run(workload, trace=trace)
    json.dumps(line)
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for value, limit in line["checks"].values():
        assert value <= limit
    bench = spec.load_benchmark()
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in spec.metrics_for(bench["per_layer"], workload)}
        # The CPU has no device trace: the readers of the card's metrics
        # find nothing and are left out.
        assert set(line["metrics"]) == names - {"sampler_roofline", "idle_share", "step_mfu"}
    else:
        names = {m["name"] for m in spec.metrics_for(bench["end_to_end"], workload)}
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
