"""Run one cell of the port's benchmark once, on the card this process finds.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the checkout's root; each configuration, traffic mix
and per-layer metric is a file of its own under ``benchmark/``. Standard
output gets one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers end standard error. The run exits non-zero without a
result when no card is found, when it needs more cards than there are, and
when JAX or the JAX package was loaded.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (0 where ``/proc`` cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


SETUP_T0 = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches of the process stay inside the checkout, at fixed
# paths, so that only a checkout's first run builds.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import drive, spec

    cell = spec.workload(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = drive.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                     SETUP_T0)
    loaded = drive.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, (value, limit) in line["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
