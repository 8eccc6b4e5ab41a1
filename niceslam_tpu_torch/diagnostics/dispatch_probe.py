"""Fixed cost per call against compute in the hot programs: the counterpart
of the JAX package's ``scripts/dispatch_probe.py``, with its probes' names
and records.

On the seed-0 map at the bench's shapes (a window of 5 frames of random
colour and depth 1.5 at identity poses, decoders frozen):

- ``overlap_sel``, ``run_schedule_staged_60``, ``run_schedule_coarse_60``:
  the keyframe overlap program (64 keyframes) and a staged and a coarse
  mapping pass of ``MappingConfig().iters`` iterations through the system's
  mapping program, each called 5 times back to back after a warm call
  (draws included), each call ended by a synchronize: ms per call;
- the mapping iteration taken apart, K = 16 iterations on 16 rows of draws
  captured as one CUDA graph (as ``kernel_bench`` captures its ops) and
  replayed, ms an iteration: ``scan_lossgrad_color``, the colour stage's
  loss and its gradients in the grids (applied at a step of 1e-9);
  ``scan_lossgrad_adam_color``, the same with the system's Adam step
  (``slam/mapper.adam_step``, one leaf at a time) over every grid level in
  its place; ``scan_lossgrad_coarse``, the coarse stage's loss and
  gradients. The second minus the first is the Adam step's share of a
  colour iteration.

    python -m niceslam_tpu_torch.diagnostics.dispatch_probe [--cpu]

One JSON line per probe on standard output. With ``--cpu`` the K iterations
run eagerly. It runs on the card unless ``--cpu`` is given, and fails where
no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config.schema import MappingConfig
from ..core.rays import draw_pixels
from ..slam import keyframes as kf_mod
from ..slam.mapper import (
    LR_COLUMNS,
    LEVEL_ORDER,
    STAGE_ORDER,
    MapOptConfig,
    ProgConfig,
    adam_step,
    bias_corrections,
    build_stage_plan,
    chunked_schedule,
    init_opt_state,
    lr_column,
    lr_zero,
    make_pass_params,
    mapping_loss,
)
from ..slam.programs import Programs, add_replays
from .mapper_step_probe import WINDOW, World, pass_draws, setup
from .world import card, synchronize

K = 16
CALLS = 5
# Every decoder frozen: the passes measure the grids' backward alone.
FROZEN_DECODERS = ((False,) * len(LEVEL_ORDER),) * len(STAGE_ORDER)


def probe_config(pixels: int = 1000):
    """``(m, mcfg, pcfg)``: the probe's mapping defaults, pass knobs and
    program configuration at ``pixels`` rays an iteration."""
    m = MappingConfig()
    return (m, MapOptConfig(frustum_feature_selection=True),
            ProgConfig(n_pixels=pixels, w_color_loss=0.2, frustum=True,
                       dec_train=FROZEN_DECODERS))


def call_ms(call, device, n: int = CALLS) -> list:
    """ms of each of ``n`` calls after a warm one, each ended by a
    synchronize."""
    call()
    synchronize(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def iteration_ms(programs: Programs, device, name: str, body, buffers) -> float:
    """ms an iteration of ``body`` (K iterations): on the card one graph of
    it, captured, replayed once warm and timed over 3 replays (the median);
    with capture off K eager iterations, run once warm and timed once."""
    if not programs.capture:
        body()
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) * 1e3 / K
    graph, delta = programs.capture_graph(device, name, body, buffers)
    ts = []
    for r in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        if r:
            ts.append(a.elapsed_time(b) / K)
    add_replays(delta, 4)
    return float(np.percentile(ts, 50))


def measure(device, world: World | None = None) -> list:
    """The probes' records, unrounded, at ``world`` (the bench's by default)."""
    device = torch.device(device)
    world = world or World()
    gen = torch.Generator(device=device).manual_seed(0)
    intr = world.intr
    colors = torch.rand((WINDOW, intr.H, intr.W, 3), generator=gen, device=device)
    s = setup(device, world, colors)
    m, mcfg, pcfg = probe_config(world.pixels)
    programs = Programs(capture=device.type == "cuda")
    recs = []

    kf_c2w = torch.eye(4, device=device).expand(64, 4, 4).contiguous()
    depth_img = torch.full((intr.H, intr.W), 1.5, device=device)
    color_img = torch.zeros((intr.H, intr.W, 3), device=device)
    eye = torch.eye(4, device=device)
    recs.append({"probe": "overlap_sel", "ms": call_ms(lambda: programs.overlap_percentages(
        intr, eye, depth_img, color_img, kf_c2w,
        *draw_pixels(gen, intr, kf_mod.OVERLAP_PIXELS, device=device)), device)})

    prog = programs.map_program((WINDOW, False, False), device, pcfg, intr, s.rcfg, s.grids,
                                s.decoders, s.cams, rows=m.iters)
    for name, coarse in (("run_schedule_staged_60", False), ("run_schedule_coarse_60", True)):
        plan = build_stage_plan(m.iters, 0.4, 0.6, m.stage_lr, coarse=coarse)
        sched = chunked_schedule(plan, mcfg, m.iters)[0][0]
        recs.append({"probe": name, "ms": call_ms(lambda: prog.run(
            s.grids, s.decoders, s.cams, s.masks, s.bounds, s.scene_bound, s.colors, s.depths,
            s.valid, s.fixed, sched, pass_draws(s, pcfg, len(sched), gen, device)), device)})

    pp = make_pass_params(s.grids, s.decoders, s.cams, pcfg)
    opt = init_opt_state(pp)
    fidx, i, j = pass_draws(s, pcfg, K, gen, device).unbind(1)
    valid = torch.as_tensor(s.valid).to(device)
    fixed = torch.as_tensor(s.fixed).to(device)
    lrs = np.zeros((1, LR_COLUMNS), np.float32)
    lrs[0, [lr_column("grids", lvl) for lvl in LEVEL_ORDER]] = 1e-3
    lrs_t = torch.as_tensor(lrs).to(device)
    c1, c2 = bias_corrections(K, device)

    def grads(stage: str, k: int):
        loss = mapping_loss(pp.params, s.bounds, s.scene_bound, intr, s.colors, s.depths, valid,
                            fixed, fidx[k], i[k], j[k], stage, pcfg.w_color_loss, s.rcfg)
        return torch.autograd.grad(loss, pp.leaves, allow_unused=True)

    def lossgrad(stage: str):
        def body():
            for k in range(K):
                g = grads(stage, k)
                with torch.no_grad():
                    for p, gk in zip(pp.leaves, g):
                        if gk is not None:
                            p.sub_(1e-9 * gk)
        return body

    def lossgrad_adam():
        for k in range(K):
            adam_step(pp, list(grads("color", k)), opt, lrs_t, c1[k:k + 1], c2[k:k + 1], None,
                      lr_zero(lrs[0]))

    def buffers():
        return [*pp.leaves, *opt.mu, *opt.nu]

    for name, body in (("scan_lossgrad_color", lossgrad("color")),
                       ("scan_lossgrad_adam_color", lossgrad_adam),
                       ("scan_lossgrad_coarse", lossgrad("coarse"))):
        recs.append({"probe": name, "ms_per_iter": iteration_ms(
            programs, device, f"dispatch_probe {name} K={K} {device}", body, buffers)})
    return recs


def rounded(rec: dict) -> dict:
    if "ms" in rec:
        return {"probe": rec["probe"], "ms": [round(t, 1) for t in rec["ms"]]}
    return {"probe": rec["probe"], "ms_per_iter": round(rec["ms_per_iter"], 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    for rec in measure(card(args.cpu)):
        print(json.dumps(rounded(rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
