#!/usr/bin/env python3
"""The sampler kernels K1 (``trilerp_fwd``), K2 (``trilerp_bwd``) and K5
(``scatter_corners``) of this checkout beside those of another checkout, on
one NVIDIA GPU.

    python3 scripts/compare_kernels.py --other DIR [--rounds 2] [--profile]

DIR holds another checkout of the repository (say the parent commit,
unpacked with ``git archive`` into the git-ignored ``ab/``); its port is
loaded as a package of its own, and its kernels build into its own
``build/kernels``. Both sides run on the inputs of ``chip_smoke.py``'s
phase 2.

- K1, on every K1 case of phase 2 (fine and middle grids at uniform
  points, at one mapping batch's points and at one mesher chunk; C = 3,
  C = 96 and a misaligned grid) and on two probes, every point in one
  voxel (its corners always in L1) and 32 points (the cost of a launch):
  both sides' ``out`` and ``dV/dv``
  compared bit for bit, and the time of each side in turns, without and
  with the derivative output.
- K2 and K5, on the uniform and surface cases: ``dgrid`` and K5's output
  against the fixed-point model of this checkout (``ops/fixed_point.py``)
  bit for bit, also with the points permuted, K2's ``dv`` against the plain
  version (2e-5) and the two sides' ``dv`` bit for bit, and their times in
  turns.

Turns are other, this, this, other (CUDA events, as
``chip_smoke.device_ms``), ``--rounds`` times. ``--profile`` adds, per case
and side, the device time of each launch inside one call of each kernel
(``torch.profiler``, averaged over 20 calls). The last line is one JSON
object; the exit code is 0 when this checkout's kernels pass every check
and K1's and K2's outputs equal the other side's bit for bit.
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


def in_turns(cs, sides, rounds, make_fn) -> dict:
    """Device ms of ``make_fn(side)()`` per side, in turns."""
    times = {side: [] for side in sides}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            times[side].append(cs.device_ms(make_fn(side)))
    return times


def probe_cases(cases):
    """Two probes on the fine case's grid: all its points at one point of
    one voxel (the corners always in L1), and its first 32 points (the
    cost of a launch)."""
    fine = cases[0]
    v = torch.tensor([10.3, 7.6, 20.2], device="cuda").expand_as(fine["v"]).contiguous()
    return [dict(fine, points="probe", v=v, name=f"fine one-voxel N={v.shape[0]}"),
            dict(fine, points="probe", v=fine["v"][:32].contiguous(), name="fine N=32")]


def compare_k1(cs, tk, sides, case, args):
    """K1 of both sides on one case: bits and times in turns."""
    grid, v, name = case["grid"], case["v"], case["name"]
    res = {"case": name}
    for deriv in (False, True):
        got = {side: k.trilerp_fwd(grid, v, deriv=deriv) for side, (k, _) in sides.items()}
        ref = tk.trilerp_fwd_plain(grid, v, deriv=deriv)
        torch.cuda.synchronize()
        (out, dout), (oout, odout) = got["this"], got["other"]
        r = dict(out_equal=torch.equal(out, oout), err=cs.max_err(out, ref[0]))
        if deriv:
            r["dout_equal"] = torch.equal(dout, odout)
            r["err"] = max(r["err"], cs.max_err(dout, ref[1]))
        r["ms"] = in_turns(cs, sides, args.rounds, lambda side: (
            lambda: sides[side][0].trilerp_fwd(grid, v, deriv=deriv)))
        if args.profile:
            r["launches_us"] = {side: launch_breakdown(
                lambda: k.trilerp_fwd(grid, v, deriv=deriv)) for side, (k, _) in sides.items()}
        equal = r["out_equal"] and r.get("dout_equal", True)
        cs.log(f"[{name}] K1 deriv={int(deriv)}: this {statistics.median(r['ms']['this']):.4f} "
               f"ms {r['ms']['this']}, other {statistics.median(r['ms']['other']):.4f} ms "
               f"{r['ms']['other']}; bit-equal to the other side {equal}; "
               f"vs plain {r['err']:.3e}"
               + (f"; launches (us per call) {r['launches_us']}" if args.profile else ""))
        res[f"deriv{int(deriv)}"] = r
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2, help="turns of other, this, this, other")
    ap.add_argument("--profile", action="store_true", help="device time of each launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device is available", file=sys.stderr)
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

    cases = cs.kernel_cases(cs.bench_config())
    k1_cases = cases + cs.k1_width_cases(cases) + probe_cases(cases)
    k1, ok, k1_equal = [], True, True
    for case in k1_cases:
        res = compare_k1(cs, tk, sides, case, args)
        k1.append(res)
        for d in ("deriv0", "deriv1"):
            ok &= res[d]["err"] <= 1e-5
            k1_equal &= res[d]["out_equal"] and res[d].get("dout_equal", True)

    grads, dv_equal = [], True
    for case in cases:
        if case["points"] not in ("uniform", "surface"):
            continue
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
        dv_equal &= res["dv_equal"]
        mine = res["this"]
        ok &= (mine["k2_model"] and mine["k2_perm"] and mine["k5_model"] and mine["k5_perm"]
               and mine["dv_err"] <= 2e-5)
        times = {
            "k2": in_turns(cs, sides, args.rounds, lambda side: (
                lambda: sides[side][0].trilerp_bwd(grid, v, g))),
            "k5": in_turns(cs, sides, args.rounds, lambda side: (
                lambda: sides[side][1].scatter_corners(idx4, ct8, R))),
        }
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
        grads.append(res)
        for side in sides:
            r = res[side]
            cs.log(f"[{name}] {side}: K2 {statistics.median(times['k2'][side]):.4f} ms "
                   f"{times['k2'][side]}, K5 {statistics.median(times['k5'][side]):.4f} ms "
                   f"{times['k5'][side]}; model K2 {r['k2_model']} (err {r['k2_model_err']:.3e}) "
                   f"perm {r['k2_perm']}, K5 {r['k5_model']} (err {r['k5_model_err']:.3e}) "
                   f"perm {r['k5_perm']}; dv vs plain {r['dv_err']:.3e}")
        cs.log(f"[{name}] dv of the two sides bit-equal: {res['dv_equal']}")
    cs.log(f"K1 out and dV/dv bit-equal to the other side in every case: {k1_equal}; "
           f"K2 dv bit-equal in every case: {dv_equal}")
    print(cs.nvidia_smi_line(), flush=True)
    passed = bool(ok and k1_equal and dv_equal)
    print(json.dumps({"ok": passed, "device": torch.cuda.get_device_name(0),
                      "k1_bits_equal": bool(k1_equal), "dv_bits_equal": bool(dv_equal),
                      "k1": k1, "grads": grads}), flush=True)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
