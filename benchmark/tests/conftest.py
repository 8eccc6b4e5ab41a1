"""Shared pieces of the benchmark's tests: the ``card`` marker, a fixture
that skips a test where no card is found, and the tiny sizes at which a
whole run of a cell fits the CPU."""
import time

import pytest
import torch

# Every width kept; the camera, the pixel budgets and the iteration counts
# cut so that a run of a cell takes seconds on the CPU.
TINY = {"cam.H": 60, "cam.W": 80, "cam.fx": 70.0, "cam.fy": 70.0, "cam.cx": 40.0,
        "cam.cy": 30.0, "cam.crop_edge": 2, "tracking.pixels": 32, "tracking.iters": 3,
        "tracking.ignore_edge_H": 4, "tracking.ignore_edge_W": 4, "mapping.pixels": 64,
        "mapping.iters": 6, "mapping.iters_first": 10}
# At these sizes a pass draws 64 rays: one colour L1 sign that flips on
# rounding moves a decoder bias by a whole Adam step, so the change limit
# is wider than the cells', and at 32 pixels a solve's mask flips on rounding
# now and then, so is the loss limit. The faults read 0.3 or more.
TINY_LIMITS = {"start_gap": 0.0, "schedule_gap": 0, "window_gap": 0, "chain_gap": 0.0,
               "track_loss_gap": 0.01, "map_first_gap": 0.01, "map_loss_gap": 0.01,
               "map_change_gap": 0.1}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def tiny_run():
    """``run(workload, seed, trace=False, seconds=4.0, sets=None)``: one run
    of a cell on the CPU at :data:`TINY` (and ``sets`` on top), its result
    line. Four seconds hold a few mapping events at these sizes."""
    from benchmark.harness import drive

    def run(workload, seed=2**31 + 11, trace=False, seconds=4.0, sets=None):
        return drive.run(workload, seed, seconds, trace, "cpu", time.perf_counter(),
                         sets={**TINY, **(sets or {})}, limits=TINY_LIMITS,
                         log=lambda *a: None)

    return run
