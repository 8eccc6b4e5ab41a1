"""Structured observability: per-event JSONL records and a frame-rate counter.

A copy of the JAX package's ``MetricsLogger``: every record gets the wall
time since the logger started (``t_wall``), goes to the in-memory
``records``, to the JSONL file at ``path`` when one is given, and, with
``verbose``, to stdout without its list and dict values.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = path
        self.verbose = verbose
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self._t0 = time.perf_counter()
        self._frames = 0
        self.records: list = []

    def log(self, record: Dict[str, Any]):
        record = dict(record)
        record["t_wall"] = round(time.perf_counter() - self._t0, 4)
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.verbose:
            brief = {k: v for k, v in record.items() if not isinstance(v, (list, dict))}
            print(f"[niceslam] {brief}")

    def frame_done(self):
        self._frames += 1

    @property
    def fps(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._frames / dt if dt > 0 else 0.0

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
