"""The control of the correctness check: the plain reference computed with
TF32 matrix products (the next precision below the configurations' float32
with TF32 off) in the program's place, judged against the float32
reference on the same sampled answers of a run's window.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed it runs the cell once (set-up, a window of ``--seconds``, the
check) and prints one JSON line: the seed, the program's compared numbers
beside their limits (``checks``), the control's numbers (``control``) and
those of a planted fault, the reference with half of each batch left out
and its loss doubled (``half_batch``).
The benchmark's own runs never run it. Needs a card.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import gc
    import json

    import torch

    from benchmark.harness import drive

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a card; none found", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = drive.run(args.workload, seed, args.seconds, False, "cuda:0",
                         time.perf_counter(), control=True, fault=True)
        print(json.dumps({"seed": seed, "correct": line["correct"], "checks": line["checks"],
                          "control": line["control"], "half_batch": line["half_batch"],
                          "metrics": line["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
