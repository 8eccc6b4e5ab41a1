"""Multi-process run of the map-sharded mapping program: the port's
counterpart of ``scripts/multihost_demo.py``.

Launch one process per host (``run_multihost_cpu.sh`` beside this file runs
N local CPU processes):

    python -m niceslam_tpu_torch.multihost_demo --num-processes 2 --process-id 0 &
    python -m niceslam_tpu_torch.multihost_demo --num-processes 2 --process-id 1

The port runs one rank per process, so a host process with
``--devices-per-process`` above 1 spawns that many rank processes (rank
``process_id * devices_per_process + local``) and waits for them; with 1 it
is its rank.
Every rank joins the process group through ``parallel/runtime.py``'s
bootstrap (``setup_runtime``, at ``tcp://{--coordinator}``), builds the
``('map', 'kf')`` mesh over every rank of every process (``--n-map`` x the
rest), and runs the system's map-sharded mapping program
(``slam/programs.MappingProgram`` with ``parallel/sharded_mapper.MapSegments``,
also on one map block; CUDA graphs around eager collectives on a card,
eager on the CPU) for
``--steps`` passes, each fed the last one's outputs, on inputs that every
rank makes from one seed. Process 0 prints one JSON line with the seconds
per pass after the first (which captures). It runs on the card unless
``--cpu`` is given: a card per rank over NCCL (more ranks than cards are
refused), or gloo ranks on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config.schema import MappingConfig, SLAMConfig
from .core.rays import Intrinsics
from .grid.hierarchy import GridConfig, init_grids
from .models.decoders import DecoderConfig, init_decoders
from .parallel.runtime import setup_runtime, spawn_ranks
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

BOUND = np.asarray([[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]], np.float32)
INTR = Intrinsics(H=32, W=32, fx=24.0, fy=24.0, cx=16.0, cy=16.0)
F = 3
GRID = GridConfig(coarse_len=1.0, middle_len=0.5, fine_len=0.25, color_len=0.25,
                  bound_divisable=0.25)


def run_rank(rank: int, args) -> None:
    """One rank: bootstrap, the shared inputs, ``args.steps`` passes; rank 0
    prints the record."""
    world = args.num_processes * args.devices_per_process
    if args.cpu:
        torch.set_num_threads(1)
    base = SLAMConfig()
    n_pixels = 32 * world
    cfg = dataclasses.replace(
        base, mapping=dataclasses.replace(base.mapping, pixels=n_pixels),
        parallel=dataclasses.replace(base.parallel, n_processes=world, map=args.n_map, kf=0,
                                     coordinator=args.coordinator))
    rt = setup_runtime(cfg, process_id=rank, cpu=args.cpu)
    try:
        mesh, dev = rt.mesh, rt.device
        if rank == 0:
            print(f"[p{args.process_id}] global ranks={world} mesh=map:{mesh.n_map} x "
                  f"kf:{mesh.n_kf} backend={rt.backend}", file=sys.stderr, flush=True)
        gen = torch.Generator().manual_seed(0)
        grids, bounds, scene_bound = init_grids(BOUND, GRID, gen, dev)
        for lvl in grids:
            grids[lvl], bounds[lvl] = pad_grid_for_sharding(grids[lvl], bounds[lvl], mesh.n_map)
        decoders = init_decoders(DecoderConfig(), gen, dev)
        colors = torch.rand((F, INTR.H, INTR.W, 3), generator=gen).to(dev)
        depths = torch.full((F, INTR.H, INTR.W), 1.2, device=dev)
        cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 0]] * F, device=dev)
        blocks = rt.split(grids)
        masks = {lvl: torch.ones(b.shape[:3] + (1,), device=dev) for lvl, b in blocks.items()}
        valid = fixed = np.ones((F,), bool)
        plan = build_stage_plan(args.iters, 0.4, 0.6, MappingConfig().stage_lr)
        mcfg = MapOptConfig(train_all_decoders=True)
        pcfg = ProgConfig(n_pixels=n_pixels, w_color_loss=0.2, frustum=True,
                          dec_train=dec_train_from_plan(plan, mcfg))
        sched = schedule_arrays(plan, mcfg)
        prog = Programs(capture=dev.type == "cuda").map_program(
            (F, False, False), dev, pcfg, INTR, RenderConfig(n_samples=8, n_surface=4), blocks,
            decoders, cams, rows=len(sched), kf=map_sharded_slice(mesh, n_pixels))
        scene_bound = torch.as_tensor(scene_bound, device=dev)
        vidx = torch.arange(F, device=dev)
        t0 = None
        for step in range(args.steps):
            draw = torch.Generator(device=dev).manual_seed(step)
            pixels = stack_draws([draw_mapping_pixels(draw, vidx, n_pixels, INTR, dev)
                                  for _ in range(len(sched))], dev)
            blocks, decoders, cams, losses = prog.run(
                blocks, decoders, cams, masks, bounds, scene_bound, colors, depths, valid,
                fixed, sched, pixels)
            losses = losses.cpu().numpy()
            if step == 0:
                t0 = time.perf_counter()  # after the capture
        dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)
        ok = bool(np.isfinite(losses).all())
        if rank == 0:
            print(json.dumps({
                "multihost": True, "processes": args.num_processes, "global_devices": world,
                "mesh": {"map": mesh.n_map, "kf": mesh.n_kf}, "finite": ok,
                "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                "s_per_mapping_step": round(dt, 4),
            }), flush=True)
        if not ok:
            raise RuntimeError(f"rank {rank}: non-finite losses {losses}")
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _local_rank(local: int, args) -> None:
    run_rank(args.process_id * args.devices_per_process + local, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9876")
    ap.add_argument("--devices-per-process", type=int, default=4,
                    help="ranks of this process (spawned when more than one)")
    ap.add_argument("--n-map", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (gloo)")
    args = ap.parse_args(argv)
    world = args.num_processes * args.devices_per_process
    if not args.cpu:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass --cpu to run on the CPU")
        if world > cards:
            raise ValueError(f"{world} ranks need a card each; this machine has {cards}")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process-id {args.process_id} is not below "
                         f"--num-processes {args.num_processes}")
    if args.devices_per_process == 1:
        _local_rank(0, args)
    else:
        spawn_ranks(_local_rank, range(args.devices_per_process), (args,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
