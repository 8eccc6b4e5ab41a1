"""Where the frame budget goes, by section: the counterpart of the JAX
package's ``scripts/perf_breakdown.py``, with its arguments, configuration
and record.

Runs the bench's frames (the JAX script's configuration: GN 200 pixels x 10
iterations, mapping 1000 pixels x 60 every 5th frame, random decoders) in
strict sync after ``precompile()``, the frames staged on the card, and
times each section of the system with a blocking timer: a synchronize, the
host clock, the section, a synchronize, the host clock. So a section's time
holds its device work and nothing queued before it. The sections are the
system's own calls, wrapped on the instance:

- ``track``: ``NiceSLAM._solve``, a frame's pose solve;
- ``retrack``: ``NiceSLAM._retrack_event_frame``, the event frame's second
  solve (``mapping.retrack``; its solve is not counted again in ``track``);
- ``overlap_sel``: the keyframe overlap program
  (``Programs.overlap_percentages``);
- ``frustum_masks``: the frustum mask program (``Programs.frustum_masks``);
- ``map_coarse`` and ``map_staged``: ``NiceSLAM._map_pass``, told apart by
  the pass's plan.

The rest of the timed window (``host_and_dispatch_*``) is host Python and
the device work between the sections. The wrapping adds synchronizations
and nothing else: the trajectory is the unwrapped run's.

    python -m niceslam_tpu_torch.diagnostics.perf_breakdown [--frames 21] [--warm 6] \
        [--bench] [--cpu]

``--bench`` times the port's bench configuration instead
(``bench.bench_config``, strict: GN 400 pixels x 20, bootstrap, free-space
term, re-track, the shipped decoders), whose budgets have moved since the
JAX script copied them; ``--frames 36`` is the bench's window. One JSON
object on standard output, the section table on standard error.
It runs on the card unless ``--cpu`` is given, and fails where no card is
found.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

from ..bench import bench_config
from ..config.schema import SLAMConfig, TrackingConfig
from ..io.datasets.base import Frame
from ..io.datasets.synthetic import SyntheticBoxReader
from ..slam.system import NiceSLAM
from .world import as_tensor, card, synchronize, world_config


def config(bench: bool = False) -> SLAMConfig:
    """The JAX script's configuration, or with ``bench`` the port's bench's
    in strict sync."""
    if bench:
        return bench_config(sync="strict")
    return world_config(TrackingConfig(pixels=200, iters=10), pretrained="")


class SectionTimer:
    """Blocking timers around a system's sections, on while ``on``; a
    section entered inside another is not counted (the outer one holds its
    time)."""

    def __init__(self, device):
        self.device, self.on, self.depth = device, False, 0
        self.total, self.calls = defaultdict(float), defaultdict(int)

    def wrap(self, fn, name, classify=None):
        def timed(*a, **kw):
            if not self.on or self.depth:
                return fn(*a, **kw)
            self.depth += 1
            try:
                synchronize(self.device)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                synchronize(self.device)
                dt = time.perf_counter() - t0
            finally:
                self.depth -= 1
            key = name if classify is None else classify(*a, **kw)
            self.total[key] += dt
            self.calls[key] += 1
            return out

        return timed


def instrument(slam: NiceSLAM) -> SectionTimer:
    """Wrap ``slam``'s sections on the instance (and on its programs)."""
    timer = SectionTimer(slam.device)
    progs = slam._programs
    slam._solve = timer.wrap(slam._solve, "track")
    slam._retrack_event_frame = timer.wrap(slam._retrack_event_frame, "retrack")
    progs.overlap_percentages = timer.wrap(progs.overlap_percentages, "overlap_sel")
    progs.frustum_masks = timer.wrap(progs.frustum_masks, "frustum_masks")
    slam._map_pass = timer.wrap(
        slam._map_pass, "map",
        classify=lambda signature, plan, *a, **kw: (
            "map_coarse" if plan[0][0] == "coarse" else "map_staged"))
    return timer


def staged_frames(reader, n: int, device) -> list:
    """The first ``n`` frames, their images on ``device``."""
    frames = []
    for k in range(n):
        f = reader[k]
        frames.append(Frame(idx=f.idx, color=as_tensor(f.color, device),
                            depth=as_tensor(f.depth, device), gt_c2w=f.gt_c2w))
    synchronize(device)
    return frames


def measure(cfg: SLAMConfig, frames: int, warm: int, device):
    """The breakdown of frames ``warm`` to ``frames - 1``, unrounded, and the
    system: ``(record, slam)``."""
    reader = SyntheticBoxReader(cfg, n_frames=frames)
    slam = NiceSLAM(cfg, reader=reader, device=device)
    slam.precompile()
    timer = instrument(slam)
    staged = staged_frames(reader, frames, device)
    for f in staged[:warm]:
        slam.step(f)
    synchronize(device)
    timer.on = True
    t0 = time.perf_counter()
    for f in staged[warm:]:
        slam.step(f)
    synchronize(device)
    total = time.perf_counter() - t0
    timer.on = False
    n = frames - warm
    attributed = sum(timer.total.values())
    sections = {
        k: {"total_s": v, "calls": timer.calls[k], "ms_per_call": v / timer.calls[k] * 1e3,
            "pct": 100 * v / total}
        for k, v in sorted(timer.total.items(), key=lambda kv: -kv[1])
    }
    return {
        "frames": n,
        "total_s": total,
        "fps": n / total,
        "sections": sections,
        "host_and_dispatch_s": total - attributed,
        "host_and_dispatch_pct": 100 * (total - attributed) / total,
    }, slam


def rounded(rec: dict) -> dict:
    return {
        "frames": rec["frames"],
        "total_s": round(rec["total_s"], 3),
        "fps": round(rec["fps"], 3),
        "sections": {k: {"total_s": round(v["total_s"], 4), "calls": v["calls"],
                         "ms_per_call": round(v["ms_per_call"], 2), "pct": round(v["pct"], 1)}
                     for k, v in rec["sections"].items()},
        "host_and_dispatch_s": round(rec["host_and_dispatch_s"], 3),
        "host_and_dispatch_pct": round(rec["host_and_dispatch_pct"], 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=21)
    ap.add_argument("--warm", type=int, default=6)
    ap.add_argument("--bench", action="store_true",
                    help="the port's bench configuration, not the JAX script's")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    rec, _ = measure(config(args.bench), args.frames, args.warm, card(args.cpu))
    out = rounded(rec)
    for k, v in out["sections"].items():
        print(f"# {k:>14}: {v['total_s']:7.3f}s  {v['pct']:5.1f}%  "
              f"({v['calls']}x {v['ms_per_call']:.1f} ms)", file=sys.stderr)
    print(f"# host+dispatch: {out['host_and_dispatch_s']:7.3f}s  "
          f"{out['host_and_dispatch_pct']:5.1f}%", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
