"""Per-iteration cost of the mapping program at the bench's shapes: the
counterpart of the JAX package's ``scripts/mapper_step_probe.py``, with its
arguments and records.

One staged mapping pass (``--iters`` iterations of the staged plan, decoders
trained) on a window of 5 frames of constant colour and depth at identity
poses, from the seed-0 grids and decoders (``init_grids``,
``init_decoders``), 1000 pixels an iteration:

- ``run_schedule``: through the system's mapping program
  (``slam/programs.MappingProgram``: on the card one CUDA graph an
  iteration of each stage, replayed row by row), a pass's draws included,
  as ``NiceSLAM`` runs it;
- ``run_schedule_eager``: the same pass through ``slam/mapper.run_schedule``
  eagerly, each iteration launched from Python;
- ``track_frame``: the pose solve's program at 200 pixels x 10 iterations
  on the first frame;
- ``implied_fps``: the frames/s that 5 solves and 2 passes (coarse and
  staged, each at the staged pass's cost) per 5 frames imply.

``capture_s`` is a program's first call, its capture on the card (the JAX
script's ``compile_s``; ``null`` where nothing is captured); ``wall_ms``
the median of ``--reps`` calls, each ended by a synchronize.

    python -m niceslam_tpu_torch.diagnostics.mapper_step_probe [--iters 60] [--reps 6] [--cpu]

One JSON line per record on standard output. It runs on the card unless
``--cpu`` is given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..bench import BOUND
from ..config.schema import MappingConfig
from ..core.pose import tensor_from_camera
from ..core.rays import Intrinsics
from ..grid.hierarchy import GridConfig, init_grids
from ..models.decoders import DecoderConfig, init_decoders
from ..render.renderer import RenderConfig
from ..slam.mapper import (
    MapOptConfig,
    ProgConfig,
    Schedule,
    build_stage_plan,
    dec_train_from_plan,
    draw_mapping_pixels,
    init_opt_state,
    make_pass_params,
    run_schedule,
    schedule_arrays,
    stack_draws,
)
from ..slam.programs import Programs
from ..slam.tracker import TrackConfig, draw_track_pixels
from .world import card, synchronize

WINDOW = 5
INTR = Intrinsics(H=480, W=640, fx=360.0, fy=360.0, cx=320.0, cy=240.0)


class World(NamedTuple):
    """The probes' shapes: the camera, the bound, the grids' voxels, the
    pixels of a mapping iteration, the samples of a ray and the pose
    solve's budget."""

    intr: Intrinsics = INTR
    bound: tuple = BOUND
    grid: GridConfig = GridConfig()
    pixels: int = 1000
    rcfg: RenderConfig = RenderConfig()
    track: TrackConfig = TrackConfig(pixels=200, iters=10)


class Setup(NamedTuple):
    """A probe's inputs on one device: the seed-0 map and a window of
    ``WINDOW`` constant frames at identity poses, every slot valid and
    fixed, all-ones update masks."""

    intr: Intrinsics
    grids: dict
    bounds: dict
    scene_bound: torch.Tensor
    decoders: dict
    colors: torch.Tensor
    depths: torch.Tensor
    cams: torch.Tensor
    valid: np.ndarray
    fixed: np.ndarray
    masks: dict
    rcfg: RenderConfig


def setup(device, world: World, colors=None) -> Setup:
    """:class:`Setup` on ``device``: colours 0.5 unless ``colors`` (a
    ``[WINDOW, H, W, 3]`` tensor) is given, depths 1.5."""
    intr = world.intr
    grids, bounds, bound_adj = init_grids(np.asarray(world.bound, np.float32), world.grid,
                                          gen=torch.Generator().manual_seed(0), device=device)
    decoders = init_decoders(DecoderConfig(),
                             gen=torch.Generator().manual_seed(0), device=device)
    eye = torch.eye(4, device=device)
    return Setup(
        intr=intr, grids=grids, bounds=bounds,
        scene_bound=torch.as_tensor(bound_adj, dtype=torch.float32).to(device),
        decoders=decoders,
        colors=(torch.full((WINDOW, intr.H, intr.W, 3), 0.5, device=device)
                if colors is None else colors),
        depths=torch.full((WINDOW, intr.H, intr.W), 1.5, device=device),
        cams=tensor_from_camera(eye.expand(WINDOW, 4, 4)),
        valid=np.ones((WINDOW,), bool), fixed=np.ones((WINDOW,), bool),
        masks={lvl: torch.ones(g.shape[:3] + (1,), device=device) for lvl, g in grids.items()},
        rcfg=world.rcfg,
    )


def staged_pass(iters: int, pixels: int = 1000):
    """``(mcfg, sched, pcfg)`` of the probe's pass: the staged plan of
    ``iters`` iterations at ``MappingConfig()``'s ratios and learning rates,
    every decoder trained, ``pixels`` rays an iteration."""
    m = MappingConfig()
    mcfg = MapOptConfig(pixels=pixels, w_color_loss=0.2, lr_factor=1.0,
                        train_all_decoders=True, decoders_lr_fallback=m.decoders_lr)
    plan = build_stage_plan(iters, m.middle_iter_ratio, m.fine_iter_ratio, m.stage_lr)
    sched = Schedule(*(x[:iters] for x in schedule_arrays(plan, mcfg)))
    pcfg = ProgConfig(n_pixels=pixels, w_color_loss=0.2, frustum=True,
                      dec_train=dec_train_from_plan(plan, mcfg))
    return mcfg, sched, pcfg


def pass_draws(s: Setup, pcfg: ProgConfig, rows: int, gen, device) -> torch.Tensor:
    """A pass's draws, every row up front, as ``NiceSLAM._map_pass`` draws
    them: ``[rows, 3, n_pixels]``."""
    valid_idx = torch.as_tensor(np.flatnonzero(s.valid)).to(device)
    return stack_draws([draw_mapping_pixels(gen, valid_idx, pcfg.n_pixels, s.intr, device)
                        for _ in range(rows)], device)


def timed_calls(call, reps: int, device):
    """``(first call's s, median s of the next reps)``, each call ended by
    a synchronize."""
    def once():
        t0 = time.perf_counter()
        call()
        synchronize(device)
        return time.perf_counter() - t0

    first = once()
    return first, float(np.percentile([once() for _ in range(reps)], 50))


def record(op: str, iters: int, first_s, wall_s: float) -> dict:
    return {"op": op, "iters": iters, "capture_s": first_s, "wall_ms": wall_s * 1e3,
            "ms_per_iter": wall_s * 1e3 / iters}


def measure(device, iters: int = 60, reps: int = 6, world: World | None = None) -> list:
    """The probe's records, unrounded, at ``world`` (the bench's by default)."""
    device = torch.device(device)
    world = world or World()
    s = setup(device, world)
    programs = Programs(capture=device.type == "cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    _, sched, pcfg = staged_pass(iters, world.pixels)
    args = (s.grids, s.decoders, s.cams, s.masks, s.bounds, s.scene_bound, s.colors, s.depths,
            s.valid, s.fixed, sched)
    prog = programs.map_program((WINDOW, False, False), device, pcfg, s.intr, s.rcfg, s.grids,
                                s.decoders, s.cams, rows=iters)
    first, wall = timed_calls(
        lambda: prog.run(*args, pass_draws(s, pcfg, iters, gen, device)), reps, device)
    recs = [record("run_schedule", iters, first if programs.capture else None, wall)]

    def eager():
        pp = make_pass_params(s.grids, s.decoders, s.cams, pcfg)
        run_schedule(pp, init_opt_state(pp), sched, s.masks, s.bounds, s.scene_bound, s.intr,
                     s.colors, s.depths, s.valid, s.fixed, pcfg, s.rcfg, gen=gen)

    _, eager_wall = timed_calls(eager, reps, device)
    recs.append(record("run_schedule_eager", iters, None, eager_wall))

    tcfg = world.track
    track = programs.track_program(device, tcfg, s.intr, s.rcfg, s.decoders, s.grids)
    eye = torch.eye(4, device=device)
    first_t, track_wall = timed_calls(
        lambda: track.run(s.decoders, s.grids, s.bounds, s.scene_bound, s.colors[0],
                          s.depths[0], eye,
                          stack_draws(draw_track_pixels(gen, s.intr, tcfg, device), device)),
        reps, device)
    recs.append(record("track_frame", tcfg.iters, first_t if programs.capture else None,
                       track_wall))
    recs.append({"op": "implied_fps", "value": 5 / (5 * track_wall + 2 * wall)})
    return recs


def rounded(rec: dict) -> dict:
    if rec["op"] == "implied_fps":
        return {"op": rec["op"], "value": round(rec["value"], 3)}
    first = rec["capture_s"]
    return {**rec, "capture_s": None if first is None else round(first, 1),
            "wall_ms": round(rec["wall_ms"], 2), "ms_per_iter": round(rec["ms_per_iter"], 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    for rec in measure(card(args.cpu), args.iters, args.reps):
        print(json.dumps(rounded(rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
