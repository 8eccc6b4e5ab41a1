"""The traced cycle: ``torch.profiler`` around a few frames, reduced in the
process to device time by kernel name, the union of device intervals, and
the idle gaps named by the host range they fall in. No trace file is
written."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

CYCLE = "bench_cycle"
HOST_RANGES = ("track", "map")


def profile_cycle(run: Callable[[], None], device: torch.device) -> dict:
    """Run ``run`` under the profiler, ending on a synchronize; returns
    :func:`reduce` of what it recorded."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(CYCLE):
            t0 = time.perf_counter()
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = torch.autograd.DeviceType.CPU
    out = reduce([(e.name(), "host" if e.device_type() == cpu else
                   "range" if e.is_user_annotation() else "device", e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()])
    out["host_wall_s"] = wall
    out["reduce_s"] = time.perf_counter() - t0
    return out


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events) -> dict:
    """From ``(name, where, start_ns, end_ns)`` records (``where``: ``host``,
    ``device`` for a kernel, copy or set on the card, or ``range`` for a
    range's copy on the card's timeline):
    ``window_s`` (the cycle's range), ``busy_s`` (the union of device
    kernel, copy and set intervals inside it), ``kernels`` (device seconds
    by name), ``gaps`` (each idle stretch's seconds and the host range at
    its start: ``track``, ``map`` or ``other``)."""
    cycle = [(s, e) for n, where, s, e in events if n == CYCLE and where == "host"]
    if not cycle:
        raise RuntimeError("the profiler recorded no cycle range")
    c0, c1 = cycle[0]
    dev_iv, kernels = [], {}
    ranges = []
    for name, where, s, e in events:
        if where == "device":
            s, e = max(s, c0), min(e, c1)
            if e > s:
                dev_iv.append((s, e))
                kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
        elif where == "host" and name in HOST_RANGES:
            ranges.append((s, e, name))
    busy = merge(dev_iv)
    gaps, prev = [], c0
    for s, e in busy + [(c1, c1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for s, e in gaps:
        host = [n for rs, re_, n in ranges if rs <= s < re_]
        named.append((host[-1] if host else "other", (e - s) * 1e-9))
    return {"window_s": (c1 - c0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": kernels, "gaps": named}


def breakdown(red: dict, top: int = 10) -> Dict[str, list]:
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
