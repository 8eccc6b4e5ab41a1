"""One run of one cell: set-up, the timed window, the traced cycle, the
check, and the result line.

The entry the window drives is ``NiceSLAM.step``, in a closed loop: the next
frame is handed over when the previous step returns. Set-up (``setup_s``)
runs from the process's start to the window: the port imported, its kernels
loaded from ``build/kernels`` in the checkout, the configuration read, one
period of the stream staged on the card, ``NiceSLAM(cfg, seed)``,
``precompile()``, the warm-up frames (frame 0's map initialisation and the
next two mapping events) and a synchronize. The window hands frames over
from the staged period until ``seconds`` have passed, then synchronizes and
flushes. The system's stream has no last frame.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from ..reference.render import camera
from . import check, spec, stream, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "niceslam_tpu")
HUGE = 10 ** 9


class Endless:
    """The system's reader: a stream with no last frame (``n_imgs``)."""

    def __len__(self):
        return HUGE


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, *args, **kwargs) -> dict:
    """:func:`_run` on the sampler route that the cell's file names (by
    default the port's own route)."""
    from niceslam_tpu_torch.ops.trilinear import get_sampler_route, sampler_route

    with sampler_route(spec.cell_file(workload).get("sampler_route", get_sampler_route())):
        return _run(workload, *args, **kwargs)


def _run(workload: str, seed: int, seconds: float, trace: bool, device, setup_t0: float,
        sets: Optional[Dict[str, object]] = None,
        limits: Optional[Dict[str, float]] = None, control: bool = False,
        fault: bool = False,
        log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """Run ``workload`` once on ``device``; returns the result line.
    ``setup_t0`` is the ``time.perf_counter()`` reading that set-up counts
    from. ``control`` adds the control's readings (``control``) and
    ``fault`` those of the reference with half of each batch left out
    (``half_batch``), for ``control.py``; ``sets`` (dotted configuration
    keys changed on top of the cell's) and ``limits`` stand in for the
    cell's own, for the tests."""
    from niceslam_tpu_torch.config.schema import SLAMConfig
    from niceslam_tpu_torch.io.datasets.base import Frame
    from niceslam_tpu_torch.slam.programs import shared_programs
    from niceslam_tpu_torch.slam.system import NiceSLAM

    device = torch.device(device)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload)
    conf = spec.config(bench, cell["config"])
    fam = spec.config_family(conf)
    traffic = spec.traffic(cell["traffic"])
    slam_d = spec.with_overrides(conf["slam"], {**traffic.get("set", {}), **(sets or {})})
    cfg = spec.build(SLAMConfig, spec.with_overrides(slam_d, fam.files(slam_d, spec.ROOT)))
    m = cfg.mapping

    colors, depths, poses = stream.stage(camera(slam_d["cam"]), cfg.bound, traffic, device)
    period = len(poses)
    phase = seed % period

    def frame(k: int):
        s = (phase + k) % period
        return Frame(idx=k, color=colors[s], depth=depths[s], gt_c2w=poses[s])

    slam = NiceSLAM(cfg, reader=Endless(), seed=seed, device=device)
    grids0, dec0 = slam.state.grids, slam.state.decoders
    rec = check.Recorder(slam, seed)
    programs = [slam._programs, shared_programs(device)]
    slam.precompile()
    k = 0
    warm = 2 * m.every_frame + 1
    while k < warm:
        slam.step(frame(k))
        k += 1
    _sync(device)
    n_capt = sum(len(p.captures) for p in programs)
    capture_s = sum(c.seconds for p in programs for c in p.captures)
    t_setup = time.perf_counter() - setup_t0

    # ---------------------------------------------------------- the window
    timer0 = (dict(slam.timer.totals), dict(slam.timer.counts))
    k0, solves0, rows0, events0 = k, rec.solves, len(rec.rows), len(slam.events)
    step_s = []
    rec.on = True
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        slam.step(frame(k))
        b = time.perf_counter()
        k += 1
        step_s.append(b - a)
        if b - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    slam.flush()
    rec.on = False
    n = len(step_s)
    win = SimpleNamespace(
        seconds=window_s, frames=n, step_s=step_s,
        track_s=slam.timer.totals.get("track", 0.0) - timer0[0].get("track", 0.0),
        track_n=slam.timer.counts.get("track", 0) - timer0[1].get("track", 0),
        map_s=slam.timer.totals.get("map", 0.0) - timer0[0].get("map", 0.0),
        map_n=slam.timer.counts.get("map", 0) - timer0[1].get("map", 0),
        captures=sum(len(p.captures) for p in programs) - n_capt,
        capture_s=capture_s, solves=rec.solves - solves0, rows=rec.rows[rows0:],
        tracked=not cfg.tracking.gt_camera)
    failed = sum(1 for e in slam.events[events0:] if e.get("event") == "map_rejected")
    failed += sum(1 for p in slam.est_c2w[-n:] if not np.isfinite(np.asarray(p)).all())

    red = cycle = None
    if trace:
        while k % m.every_frame:
            slam.step(frame(k))
            k += 1
        _sync(device)
        s0, r0 = rec.solves, len(rec.rows)

        def run_cycle():
            nonlocal k
            for _ in range(m.every_frame):
                slam.step(frame(k))
                k += 1

        red = tracing.profile_cycle(run_cycle, device)
        slam.flush()
        cycle = SimpleNamespace(solves=rec.solves - s0, rows=rec.rows[r0:])
        log(f"traced cycle: frames {k - m.every_frame}-{k - 1}, host wall "
            f"{red['host_wall_s']:.4f} s, reduced in {red['reduce_s']:.2f} s")

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # ------------------------------------------------ the check, state freed
    rec.detach()
    del slam, programs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = {"start_gap": check.start_gap(slam_d, fam, seed, grids0, dec0, spec.ROOT),
               "schedule_gap": check.schedule_gap(rec, slam_d, fam, range(k0, k0 + n)),
               "chain_gap": check.chain_gap(rec)}
    del grids0, dec0
    numbers["window_gap"], fixed = check.window_gap(rec, slam_d, fam,
                                                    lambda j: (frame(j).color, frame(j).depth))
    ref = check.reference_answers(rec, slam_d, fam, device, fixed)
    numbers.update(check.gaps(rec, slam_d, fam, ref, log=log))
    control_numbers = None
    if control:
        low = check.reference_answers(rec, slam_d, fam, device, fixed, use_tf32=True)
        control_numbers = check.gaps(rec, slam_d, fam, ref, program=low,
                                     log=lambda m: log(f"control {m}"))
    fault_numbers = None
    if fault:
        half = check.reference_answers(rec, slam_d, fam, device, fixed, half_batch=True)
        fault_numbers = check.gaps(rec, slam_d, fam, ref, program=half,
                                   log=lambda m: log(f"half batch {m}"))
    log(f"check: {len(rec.sampled_solves)} solves and {len(rec.sampled_event)} passes "
        f"against the reference in {time.perf_counter() - t_check:.2f} s")
    limits = limits or spec.cell_file(workload)["limits"]
    checks = {name: [value, limits[name]] for name, value in numbers.items()}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    # ------------------------------------------------------------- metrics
    metrics = {}
    e2e = spec.metrics_for(bench["end_to_end"], workload)
    if not trace:
        values = {"frames_per_s": n / window_s,
                  "frame_p95_ms": 1e3 * float(np.percentile(step_s, 95)),
                  "setup_s": t_setup}
        for e in e2e:
            metrics[e["name"]] = {"value": values[e["name"]], "unit": e["unit"]}
    else:
        ctx = SimpleNamespace(config=slam_d, window=win, trace=red, cycle=cycle,
                              costs=fam.costs, device=device, log=log,
                              grid_bytes=fam.costs.grid_bytes(slam_d),
                              device_name=(torch.cuda.get_device_name(device)
                                           if device.type == "cuda" else "cpu"))
        for e in spec.metrics_for(bench["per_layer"], workload):
            v = spec.metric_reader(e["name"])(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    log(f"window: {n} frames in {window_s:.4f} s ({n / window_s:.4f} frames/s), p50 "
        f"{1e3 * statistics.median(step_s):.3f} ms, setup {t_setup:.3f} s, captures before "
        f"{n_capt} ({capture_s:.3f} s), in the window {win.captures}, peak "
        f"{peak / 2**20:.1f} MiB")

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": n, "failed": failed, "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        line["breakdown"] = tracing.breakdown(red)
    if control_numbers is not None:
        line["control"] = control_numbers
    if fault_numbers is not None:
        line["half_batch"] = fault_numbers
    line["checks"] = checks
    return line
