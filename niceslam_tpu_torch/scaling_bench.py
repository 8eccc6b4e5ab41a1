"""Mapping-throughput scaling over ranks: the port's counterpart of
``scripts/scaling_bench.py``.

    python -m niceslam_tpu_torch.scaling_bench [--devices 1 2 4] [--pixels 1000]
        [--iters 30] [--strong] [--cpu N] [--real-1x1]

It times the whole mapping pass (render forward and backward, Adam, every
stage) of one window as the system runs it (``slam/programs.MappingProgram``:
CUDA graphs on a card, eager on the CPU) on 1, 2, 4, ... ranks with the ray
batch sharded over them (the mesh's ``kf`` axis, ``parallel/``; one
all_reduce of the gradients an iteration), in the JAX script's world: the
Co-Fusion bound, 640x480, a window of 5 frames of uniform colours at depth
1.5 with identity cameras, ``build_stage_plan(iters, 0.4, 0.6)``, frustum
selection off.

- weak scaling (default): the pixel budget grows with the ranks (fixed
  work per rank), efficiency ``t(1) / t(N)``;
- strong scaling (``--strong``): a fixed pixel budget, efficiency
  ``t(1) / (N t(N))``.

A mesh size is a number of ranks, one process each. On the card every rank
has a card of its own (NCCL): a size above the number of cards is refused,
as the JAX script cannot exceed its devices. With ``--cpu N`` the ranks are
gloo processes on the CPU and the sizes go up to ``N`` (what the mechanics
do, not what a card's bandwidth does). One JSON line per size, with the JAX
script's keys; a size's time is the median of 3 passes on its slowest rank.

``--real-1x1`` times, on one device, the map-sharded program on a 1 x 1 mesh
(``parallel/sharded_mapper.MapSegments`` forced onto one map block: the
iteration as its segments, with no rank to sum over) against the unsharded
program, each as a chain of 6 passes whose outputs feed the next (the
moments restart each pass, as in the system): a line per program with its
``sentinel`` (last loss plus one grid value, so both did the work), then
``real_chip_1x1_overhead``, the segments' cost over one graph.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .config.schema import MappingConfig, SLAMConfig
from .core.rays import Intrinsics
from .grid.hierarchy import GridConfig, init_grids
from .models.decoders import DecoderConfig, init_decoders
from .parallel.mesh import make_mesh
from .parallel.runtime import free_port, setup_runtime, spawn_ranks
from .parallel.sharded_mapper import map_sharded_slice, pad_grid_for_sharding
from .render.renderer import RenderConfig
from .slam.mapper import (
    MapOptConfig,
    ProgConfig,
    build_stage_plan,
    dec_train_from_plan,
    draw_mapping_pixels,
    schedule_arrays,
    stack_draws,
)
from .slam.programs import Programs

BOUND = np.asarray([[-4.5, 3.82], [-1.5, 2.02], [-3.0, 2.76]], np.float32)
INTR = Intrinsics(H=480, W=640, fx=360.0, fy=360.0, cx=320.0, cy=240.0)
F = 5
# Passes timed per mesh size (after one that captures), and the chain of
# --real-1x1.
PASSES, CHAIN = 3, 6


def world(device, n_map: int = 1):
    """The JAX script's inputs on ``device``: grids (padded for ``n_map``
    map blocks), their bounds and the scene bound, decoders, colours, depths,
    cameras, all-ones masks, every frame valid and fixed."""
    grids, bounds, scene_bound = init_grids(
        BOUND, GridConfig(), torch.Generator().manual_seed(0), device)
    for lvl in grids:
        grids[lvl], bounds[lvl] = pad_grid_for_sharding(grids[lvl], bounds[lvl], n_map)
    decoders = init_decoders(DecoderConfig(), torch.Generator().manual_seed(0), device)
    colors = torch.rand((F, INTR.H, INTR.W, 3), generator=torch.Generator().manual_seed(0))
    return dict(
        grids=grids, bounds=bounds,
        scene_bound=torch.as_tensor(scene_bound, device=device),
        decoders=decoders, colors=colors.to(device),
        depths=torch.full((F, INTR.H, INTR.W), 1.5, device=device),
        cams=torch.tensor([[1.0, 0, 0, 0, 0, 0, 0]] * F, device=device),
        masks={lvl: torch.ones(g.shape[:3] + (1,), device=device) for lvl, g in grids.items()},
        valid=np.ones((F,), bool), fixed=np.ones((F,), bool),
    )


def pass_config(iters: int, pixels: int):
    """``(schedule, ProgConfig)`` of the JAX script's pass."""
    plan = build_stage_plan(iters, 0.4, 0.6, MappingConfig().stage_lr)
    mcfg = MapOptConfig(frustum_feature_selection=False)
    pcfg = ProgConfig(n_pixels=pixels, w_color_loss=0.2, frustum=False, ba=False,
                      dec_train=dec_train_from_plan(plan, mcfg))
    return schedule_arrays(plan, mcfg), pcfg


def draws(seed: int, n_rows: int, pixels: int, device) -> torch.Tensor:
    """``[rows, 3, pixels]`` draws of a pass from a generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    valid = torch.arange(F, device=device)
    return stack_draws([draw_mapping_pixels(gen, valid, pixels, INTR, device)
                        for _ in range(n_rows)], device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program(programs: Programs, w: dict, sched, pcfg, device, kf=None):
    return programs.map_program((F, False, False), device, pcfg, INTR, RenderConfig(),
                                w["grids"], w["decoders"], w["cams"], rows=len(sched), kf=kf)


def run_pass(prog, w: dict, grids, decoders, cams, sched, pixels):
    return prog.run(grids, decoders, cams, w["masks"], w["bounds"], w["scene_bound"],
                    w["colors"], w["depths"], w["valid"], w["fixed"], sched, pixels)


def _rank(rank: int, world_size: int, coordinator: str, cpu: bool, iters: int, pixels: int,
          out_dir: str) -> None:
    """One rank of a mesh of ``world_size`` ranks on the kf axis: the pass
    once to capture, then ``PASSES`` timed; writes its median seconds."""
    if cpu:
        torch.set_num_threads(1)
    cfg = SLAMConfig()
    cfg = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, pixels=pixels),
        parallel=dataclasses.replace(cfg.parallel, n_processes=world_size, map=1, kf=0,
                                     coordinator=coordinator))
    rt = setup_runtime(cfg, process_id=rank, cpu=cpu)
    try:
        dev = rt.device
        w = world(dev)
        sched, pcfg = pass_config(iters, pixels)
        kf = rt.kf_slice(pixels) if world_size > 1 else None
        prog = program(Programs(capture=dev.type == "cuda"), w, sched, pcfg, dev, kf)
        pix = draws(2, len(sched), pixels, dev)
        secs = []
        for k in range(PASSES + 1):
            sync(dev)
            t0 = time.perf_counter()
            run_pass(prog, w, w["grids"], w["decoders"], w["cams"], sched, pix)
            sync(dev)
            secs.append(time.perf_counter() - t0)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump({"t": statistics.median(secs[1:]), "platform": dev.type}, fh)
    finally:
        if world_size > 1:
            torch.distributed.destroy_process_group()


def platform(cpu: bool) -> str:
    return "cpu" if cpu else "gpu"


def scaling(sizes, pixels: int, iters: int, strong: bool, cpu: bool) -> list:
    """One record per mesh size, as the JAX script prints them."""
    rows, t1 = [], None
    for n in sizes:
        px = pixels if strong else pixels * n
        with tempfile.TemporaryDirectory() as tmp:
            spawn_ranks(_rank, range(n),
                        (n, f"localhost:{free_port()}", cpu, iters, px, tmp))
            t = max(json.load(open(os.path.join(tmp, f"rank{r}.json")))["t"] for r in range(n))
        if t1 is None:
            t1 = t
        eff = (t1 / t) if not strong else (t1 / (n * t))
        row = {"mesh_devices": n, "pixels": px, "iters": iters, "t_step_s": round(t, 4),
               "scaling_efficiency": round(eff, 4), "mode": "strong" if strong else "weak",
               "platform": platform(cpu)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def real_1x1(pixels: int, iters: int, cpu: bool) -> dict:
    """The 1 x 1 map-sharded program against the unsharded one on one
    device, each a chain of ``CHAIN`` passes after one that captures;
    prints a line per program and the overhead, returns the records."""
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    w = world(dev, n_map=1)
    sched, pcfg = pass_config(iters, pixels)
    programs = Programs(capture=not cpu)
    rows = {}
    one_block = map_sharded_slice(make_mesh(1, 1), pixels)
    for name, kf in (("unsharded", None), ("sharded_1x1", one_block)):
        prog = program(programs, w, sched, pcfg, dev, kf)
        g, d, c, _ = run_pass(prog, w, w["grids"], w["decoders"], w["cams"], sched,
                              draws(0, len(sched), pixels, dev))
        sync(dev)
        t0 = time.perf_counter()
        for i in range(1, CHAIN + 1):
            g, d, c, losses = run_pass(prog, w, g, d, c, sched, draws(i, len(sched), pixels, dev))
        sentinel = float(losses[-1]) + float(g["middle"][0, 0, 0, 0])
        rows[name] = {"prog": name, "pixels": pixels, "iters": iters,
                      "t_step_s": round((time.perf_counter() - t0) / CHAIN, 4),
                      "sentinel": round(sentinel, 3), "platform": platform(cpu),
                      "losses": losses.cpu().numpy()}
        print(json.dumps({k: v for k, v in rows[name].items() if k != "losses"}), flush=True)
    over = {"real_chip_1x1_overhead": round(
        rows["sharded_1x1"]["t_step_s"] / rows["unsharded"]["t_step_s"] - 1.0, 4),
        "platform": platform(cpu)}
    print(json.dumps(over), flush=True)
    return {**rows, **over}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="mesh sizes (ranks) to test (default 1, 2, 4, .. up to the cards)")
    ap.add_argument("--pixels", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--strong", action="store_true")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="run the ranks on the CPU, up to N of them")
    ap.add_argument("--real-1x1", action="store_true",
                    help="the map-sharded program on a 1x1 mesh against the unsharded "
                         "program on one device")
    args = ap.parse_args(argv)
    cpu = args.cpu > 0
    if cpu:
        n_dev = args.cpu
    else:
        n_dev = torch.cuda.device_count()
        if n_dev == 0:
            raise RuntimeError("no CUDA device is available; pass --cpu N to run on the CPU")
    if args.real_1x1:
        real_1x1(args.pixels, args.iters, cpu)
        return 0
    sizes = args.devices
    if not sizes:
        sizes, s = [], 1
        while s <= n_dev:
            sizes.append(s)
            s *= 2
    too_big = [n for n in sizes if not 1 <= n <= n_dev]
    if too_big:
        raise ValueError(f"mesh sizes {too_big} need more ranks than the "
                         f"{n_dev} {'CPU ranks asked for' if cpu else 'card(s)'}")
    scaling(sizes, args.pixels, args.iters, args.strong, cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
