#!/usr/bin/env python3
"""The grid-gradient kernels K2 (``trilerp_bwd``) and K5 (``scatter_corners``)
of this checkout beside those of another checkout, on one NVIDIA GPU.

    python3 scripts/compare_grad_kernels.py --other DIR [--rounds 2] [--profile]

DIR holds another checkout of the repository (say the parent commit,
unpacked with ``git archive`` into the git-ignored ``ab/``); its port is
loaded as a package of its own, and its kernels
build into its own ``build/kernels``. Both sides run on the inputs of
``chip_smoke.py``'s phase 2: the fine and middle grids at uniform random
points and at the points of one mapping batch. For each case and side it
checks K2's ``dgrid`` and K5's output against the fixed-point model of this
checkout (``ops/fixed_point.py``) bit for bit, also with the points
permuted, and K2's ``dv`` against the plain version (2e-5); it compares the
two sides' ``dv`` bit for bit, and times each kernel on both sides in turns
(other, this, this, other; CUDA events, as ``chip_smoke.device_ms``). The
last line is one JSON object; the exit code is 0 when this checkout's
kernels pass every check. ``--profile`` adds, per case and side, the
device time of each launch inside one call of K2 and of K5
(``torch.profiler``, averaged over 20 calls).
"""
import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_other(path):
    """The ``ops`` kernel modules of the port in checkout ``path``, as the
    package ``other_port``."""
    pkg = os.path.join(os.path.abspath(path), "niceslam_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("other_port.ops.trilerp_kernels"),
            importlib.import_module("other_port.ops.packed_kernels"))


def launch_breakdown(fn, calls: int = 20) -> dict:
    """Device microseconds per call of each kernel (and memset) that
    ``fn`` launches, by name, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1][:60]
            rows[name] = rows.get(name, 0.0) + e.self_device_time_total / calls
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2, help="turns of other, this, this, other")
    ap.add_argument("--profile", action="store_true", help="device time of each launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_grad_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from niceslam_tpu_torch.ops import fixed_point as fp
    from niceslam_tpu_torch.ops import packed_kernels as pk
    from niceslam_tpu_torch.ops import trilerp_kernels as tk
    from niceslam_tpu_torch.ops.trilinear import packed_starts

    otk, opk = load_other(args.other)
    sides = {"this": (tk, pk), "other": (otk, opk)}
    cs.log(f"card: {cs.nvidia_smi_line()}")
    srcs = [(t, src) for t, p in sides.values() for src in (t.CSRC / "trilerp.cu", p.SRC)]
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(lambda ts: ts[0].build(ts[1], verbose=True), srcs))
    for lib, report in built:
        cs.log(f"build: {lib}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log(f"  ptxas: {line.strip()}")

    cases, ok = [], True
    for case in cs.kernel_cases(cs.bench_config()):
        grid, v, g, perm, name = case["grid"], case["v"], case["g"], case["perm"], case["name"]
        Z, Y, X, C = grid.shape
        R = Z * Y * X
        start, w = packed_starts(v, (Z, Y, X))
        idx4 = pk.pair_starts(start, Y, X)
        ct8 = (pk.corner_weights(w[:, 0], w[:, 1], w[:, 2])[:, :, None]
               * g[:, None, :]).contiguous()
        vp, gp = v[perm].contiguous(), g[perm].contiguous()
        idx4p, ct8p = idx4[perm].contiguous(), ct8[perm].contiguous()
        m2 = fp.trilerp_bwd_fixed_point(grid, v, g)
        m5 = fp.scatter_corners_fixed_point(idx4, ct8, R)
        _, rdv = tk.trilerp_bwd_plain(grid, v, g, need_dgrid=False)
        res, dvs = {"case": name}, {}
        for side, (k2, k5) in sides.items():
            dgrid, dv = k2.trilerp_bwd(grid, v, g)
            pdgrid, _ = k2.trilerp_bwd(grid, vp, gp, need_dv=False)
            out5 = k5.scatter_corners(idx4, ct8, R)
            pout5 = k5.scatter_corners(idx4p, ct8p, R)
            torch.cuda.synchronize()
            res[side] = dict(
                k2_model=torch.equal(dgrid, m2), k2_perm=torch.equal(pdgrid, m2),
                k5_model=torch.equal(out5, m5), k5_perm=torch.equal(pout5, m5),
                k2_model_err=cs.max_err(dgrid, m2), k5_model_err=cs.max_err(out5, m5),
                dv_err=cs.max_err(dv, rdv))
            dvs[side] = dv
        res["dv_equal"] = torch.equal(dvs["this"], dvs["other"])
        mine = res["this"]
        ok &= (mine["k2_model"] and mine["k2_perm"] and mine["k5_model"] and mine["k5_perm"]
               and mine["dv_err"] <= 2e-5)
        times = {side: {"k2": [], "k5": []} for side in sides}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                k2, k5 = sides[side]
                times[side]["k2"].append(cs.device_ms(lambda: k2.trilerp_bwd(grid, v, g)))
                times[side]["k5"].append(
                    cs.device_ms(lambda: k5.scatter_corners(idx4, ct8, R)))
        res["ms"] = times
        if args.profile:
            res["launches_us"] = {
                side: {"k2": launch_breakdown(lambda: k2.trilerp_bwd(grid, v, g)),
                       "k5": launch_breakdown(lambda: k5.scatter_corners(idx4, ct8, R))}
                for side, (k2, k5) in sides.items()}
            for side, kb in res["launches_us"].items():
                for k, rows in kb.items():
                    cs.log(f"[{name}] {side} {k} launches (us per call): "
                           + ", ".join(f"{n} {t:.2f}" for n, t in rows.items()))
        cases.append(res)
        for side in sides:
            r = res[side]
            cs.log(f"[{name}] {side}: K2 {statistics.median(times[side]['k2']):.4f} ms "
                   f"{times[side]['k2']}, K5 {statistics.median(times[side]['k5']):.4f} ms "
                   f"{times[side]['k5']}; model K2 {r['k2_model']} (err {r['k2_model_err']:.3e}) "
                   f"perm {r['k2_perm']}, K5 {r['k5_model']} (err {r['k5_model_err']:.3e}) "
                   f"perm {r['k5_perm']}; dv vs plain {r['dv_err']:.3e}")
        cs.log(f"[{name}] dv of the two sides bit-equal: {res['dv_equal']}")
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": bool(ok), "device": torch.cuda.get_device_name(0),
                      "cases": cases}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
