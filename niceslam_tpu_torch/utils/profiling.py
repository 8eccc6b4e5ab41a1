"""Profiling hooks and wall-clock section timing of the SLAM loop.

- :func:`trace` records everything inside the block with ``torch.profiler``
  (host and, where CUDA is available, the card's kernels) and writes one
  Chrome trace, ``trace.json``, into ``log_dir``.
- :func:`annotate` names a range: a ``record_function`` that the trace
  shows, and an NVTX range for an external profiler once CUDA is
  initialised (``torch.cuda.nvtx`` raises on a CPU-only build). Outside a
  trace it costs a few microseconds of host time and launches nothing.
  ``NiceSLAM.step`` names its ``track`` and ``map`` sections so.
- ``StepTimer`` is the JAX package's section timer on the host clock. It
  does not wait for the card: in strict sync a section ends after the host
  has read its results back, so it covers the device work; in async sync it
  covers what the host spent queueing it.

The JAX package's ``start_server`` (a live profiler for tensorboard) has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record everything inside the block; write ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's trace (and NVTX, once CUDA is up)."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Cheap wall-clock section timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(v, 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
            }
            for k, v in sorted(self.totals.items())
        }
