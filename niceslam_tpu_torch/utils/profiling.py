"""Wall-clock section timing of the SLAM loop.

``StepTimer`` is the JAX package's section timer on the host clock. It does
not wait for the card: in strict sync a section ends after the host has read
its results back, so it covers the device work; in async sync it covers
what the host spent queueing it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


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
