"""Pretrain the decoder hierarchy on randomized analytic room scenes.

The counterpart of the JAX package's ``scripts/pretrain_decoders.py``, whose
recipe it follows step for step: SLAM keeps the middle and fine decoders
frozen, so they must map grid features to occupancy and colour before any
scene is seen. Shared decoders and per-scene grids are trained jointly on
``scenes`` scenes, cycling over three bound envelopes (:data:`BOUND_SET`):

- each scene is a room box (interior free) with :data:`N_OBS` solid obstacle
  boxes, sizes and offsets drawn per scene (:func:`scene_geometry`), so only
  the grid features can carry the geometry;
- occupancy targets ``tanh(sd / width)`` per stage (middle, fine, and coarse
  with a wider transition over the enlarged coarse bound), Huber-penalised;
- raw rgb at near-surface points against a per-scene wall palette times the
  synthetic dataset's checkerboard shading, L1;
- a calibration on all-zero grids, the SLAM start state, pulling every
  stage's occupancy to ``cal_target``, and a small L2 on the grids.

One step draws its point sets on the device (:func:`draw_batch`), evaluates
:func:`pretrain_loss` (``nice_forward`` at four stages, so the sampler's
kernels run forward on every level and backward into the live grids) and
takes an ``optax.adam`` step on every decoder leaf and every grid. The step
after the draws is a program (:class:`PretrainProgram`, one per bound
envelope, as the script keeps one jitted step per envelope): on the card a
replay of a captured CUDA graph, each captured before the first scene of
its envelope. Nothing inside a scene reads a value back to the host; the
loss is read once at the scene's end.

    python -m niceslam_tpu_torch.pretrain_decoders [--cpu] [--scenes 24]
        [--steps 400] [--batch 4096] [--out output/pretrained_decoders_torch.npz]

The result loads from a config as ``pretrained_decoders.middle_fine``. It
runs on the card unless ``--cpu`` is given, and never writes the shipped
``models/pretrained_decoders.npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .grid.hierarchy import GridConfig, init_grids
from .models.decoders import DecoderConfig, init_decoders, nice_forward, tree_leaves, tree_map
from .models.pretrained import save_decoders_npz
from .ops.trilinear import get_sampler_route
from .slam.mapper import adam_direction, adam_moments_, bias_corrections
from .slam.programs import (
    Programs,
    add_replays,
    clone_tree,
    indexed_device,
    pool_bytes,
    resolve_capture,
    shared_programs,
)
from .slam.tracker import huber

N_OBS = 3  # obstacles per scene

# Three coordinate envelopes the SLAM configs exercise: a small room, the
# bench's room, a large hall.
BOUND_SET = (
    ((-2.2, 2.2), (-2.2, 2.2), (-2.2, 2.2)),
    ((-4.5, 3.82), (-1.5, 2.02), (-3.0, 2.76)),
    ((-6.0, 5.6), (-2.5, 3.1), (-5.0, 4.6)),
)

SHIPPED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models", "pretrained_decoders.npz")

Batch = Dict[str, torch.Tensor]


class PretrainConfig(NamedTuple):
    """The script's flags and their defaults."""

    scenes: int = 24
    steps: int = 400  # optimization steps per scene
    batch: int = 4096
    decoders_lr: float = 1e-3
    grids_lr: float = 1e-2
    width: float = 0.05  # occupancy transition half-width [m], middle / fine
    width_coarse: float = 0.30
    cal_target: float = -0.35
    out: str = "output/pretrained_decoders_torch.npz"
    seed: int = 0


# ------------------------------------------------------------- the scenes
def scene_geometry(rng: np.random.Generator, adj_bound: np.ndarray) -> Dict[str, np.ndarray]:
    """One scene's room ``[3, 2]``, obstacles ``[N_OBS, 3, 2]``, wall palette
    ``[6, 3]`` and obstacle colors ``[N_OBS, 3]`` (float32), drawn from
    ``rng`` in the script's order, inside the adjusted bound."""
    ext = adj_bound[:, 1] - adj_bound[:, 0]
    shrink = rng.uniform(0.72, 0.95, 3)
    room_ext = ext * shrink
    slack = ext - room_ext
    room_min = adj_bound[:, 0] + rng.uniform(0, 1, 3) * slack
    room = np.stack([room_min, room_min + room_ext], -1)
    obs = []
    for _ in range(N_OBS):
        oe = room_ext * rng.uniform(0.08, 0.3, 3)
        omin = room_min + rng.uniform(0.05, 0.9, 3) * (room_ext - oe)
        obs.append(np.stack([omin, omin + oe], -1))
    palette = rng.uniform(0.15, 0.95, (6, 3))
    obs_color = rng.uniform(0.15, 0.95, (N_OBS, 3))
    return {
        "room": room.astype(np.float32),
        "obs": np.stack(obs).astype(np.float32),
        "palette": palette.astype(np.float32),
        "obs_color": obs_color.astype(np.float32),
    }


def _uniform(gen, n: int, box: torch.Tensor) -> torch.Tensor:
    """``n`` points uniform in the axis-aligned ``box [3, 2]``."""
    u = torch.rand((n, 3), generator=gen, device=box.device)
    return box[:, 0] + u * (box[:, 1] - box[:, 0])


def surface_points(gen, n: int, box: torch.Tensor, jitter: float):
    """``n`` points near the surface of ``box [3, 2]`` and their face index
    ``[n]`` in ``[0, 6)`` (``axis * 2 + (0 min face, 1 max face)``)."""
    p = _uniform(gen, n, box)
    face = torch.randint(0, 6, (n,), generator=gen, device=box.device)
    axis, side = face // 2, face % 2
    on_face = axis[:, None] == torch.arange(3, device=box.device)
    p = torch.where(on_face, box[axis, side][:, None], p)
    return p + jitter * torch.randn((n, 3), generator=gen, device=box.device), face


def draw_batch(gen, geom: Dict[str, torch.Tensor], grid_bounds: Dict[str, torch.Tensor],
               batch: int) -> Batch:
    """Every random point set of one step, from ``gen`` on the device of
    ``geom``: ``p_uni [B, 3]`` in the scene bound, ``p_room [B/2, 3]`` and
    its faces ``f_room`` near the room's walls, ``p_obs [N_OBS * n_per, 3]``
    near the obstacles (``n_per = max(B // (2 N_OBS), 1)`` each), and
    ``p_c [B, 3]`` in the coarse bound."""
    p_uni = _uniform(gen, batch, grid_bounds["middle"])
    p_room, f_room = surface_points(gen, batch // 2, geom["room"], 0.06)
    n_per = max(batch // (2 * N_OBS), 1)
    p_obs = torch.cat([surface_points(gen, n_per, geom["obs"][j], 0.04)[0]
                       for j in range(N_OBS)])
    p_c = _uniform(gen, batch, grid_bounds["coarse"])
    return {"p_uni": p_uni, "p_room": p_room, "f_room": f_room, "p_obs": p_obs, "p_c": p_c}


# ---------------------------------------------------------------- the loss
def sd_box_outside(p: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Max-norm signed distance to ``box [3, 2]``: > 0 outside, < 0 inside."""
    return torch.maximum(box[:, 0] - p, p - box[:, 1]).amax(dim=-1)


def sd_occupied(p: torch.Tensor, room: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """> 0 inside the occupied region: outside the room or inside an obstacle."""
    sd = sd_box_outside(p, room)
    for k in range(N_OBS):
        sd = torch.maximum(sd, -sd_box_outside(p, obs[k]))
    return sd


def checker_shade(p: torch.Tensor) -> torch.Tensor:
    """The synthetic dataset's 0.5 m checkerboard: 0.75 or 1.0. A floored
    modulo (``remainder``), as the coordinates are negative over half of
    every envelope."""
    return 0.75 + 0.25 * torch.remainder(torch.floor(p / 0.5).sum(dim=-1), 2.0)


def occupancy_points(batch: Batch) -> torch.Tensor:
    """The occupancy-supervised points: uniform, room walls, obstacles."""
    return torch.cat([batch["p_uni"], batch["p_room"], batch["p_obs"]])


def calibration_points(pts: torch.Tensor) -> torch.Tensor:
    """About 1024 of the occupancy points, every ``len // 1024``-th."""
    return pts[:: max(pts.shape[0] // 1024, 1)]


def pretrain_loss(decoders, grids: Dict[str, torch.Tensor], batch: Batch,
                  geom: Dict[str, torch.Tensor], grid_bounds: Dict[str, torch.Tensor],
                  cfg: PretrainConfig):
    """The step's loss ``(total, aux)``: Huber occupancy per stage, ``0.5 x``
    the color L1, ``0.3 x`` the calibration on zero grids and ``1e-2 x``
    the grids' mean squares; ``aux`` holds the terms ``m, f, c, col, cal``."""
    room, obs = geom["room"], geom["obs"]
    pts = occupancy_points(batch)
    t_mf = torch.tanh(sd_occupied(pts, room, obs) / cfg.width)
    occ_m = nice_forward(decoders, grids, pts, grid_bounds, "middle")[:, 3]
    occ_f = nice_forward(decoders, grids, pts, grid_bounds, "fine")[:, 3]
    loss_m = huber(occ_m - t_mf).mean()
    loss_f = huber(occ_f - t_mf).mean()

    # Coarse: its own wide transition, sampled over the enlarged coarse
    # bound so that it learns "beyond the room shell = occupied".
    p_c = batch["p_c"]
    t_c = torch.tanh(sd_occupied(p_c, room, obs) / cfg.width_coarse)
    occ_c = nice_forward(decoders, grids, p_c, grid_bounds, "coarse")[:, 3]
    loss_c = huber(occ_c - t_c).mean()

    p_col = torch.cat([batch["p_room"], batch["p_obs"]])
    n_per = batch["p_obs"].shape[0] // N_OBS
    c_tgt = torch.cat([
        geom["palette"][batch["f_room"]],
        geom["obs_color"][:, None].expand(N_OBS, n_per, 3).reshape(-1, 3),
    ]) * checker_shade(p_col)[:, None]
    rgb = nice_forward(decoders, grids, p_col, grid_bounds, "color")[:, :3]
    loss_col = (rgb - c_tgt).abs().mean()

    # Fresh-grid calibration: the grids are constants here, the decoders
    # still get a gradient.
    zero_grids = {k: torch.zeros_like(g) for k, g in grids.items()}
    p_cal = calibration_points(pts)
    cal = 0.0
    for stage in ("middle", "fine", "coarse"):
        o0 = nice_forward(decoders, zero_grids, p_cal, grid_bounds, stage)[:, 3]
        cal = cal + ((o0 - cfg.cal_target) ** 2).mean()

    reg = sum((g * g).mean() for g in grids.values())
    total = loss_m + loss_f + loss_c + 0.5 * loss_col + 0.3 * cal + 1e-2 * reg
    aux = {"m": loss_m, "f": loss_f, "c": loss_c, "col": loss_col, "cal": cal}
    return total, aux


def trainable_leaves(decoders, grids: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Every decoder leaf (``embed_B`` included: its gradient is zero, as in
    the script, which differentiates the whole tree), then every grid."""
    return tree_leaves(decoders) + list(grids.values())


def loss_and_grads(decoders, grids, batch, geom, grid_bounds, cfg: PretrainConfig):
    """``(total, aux, grads)``, one gradient per :func:`trainable_leaves`
    entry (``None`` where it is zero by construction)."""
    total, aux = pretrain_loss(decoders, grids, batch, geom, grid_bounds, cfg)
    grads = torch.autograd.grad(total, trainable_leaves(decoders, grids), allow_unused=True)
    return total, aux, grads


# -------------------------------------------------------------- training
def _copy_dict_(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    torch._foreach_copy_(list(dst.values()), [src[k] for k in dst])


class PretrainProgram:
    """The pretraining step of one bound envelope over static buffers: the
    decoders and a scene's grids (leaves that require grad), their Adam
    moments, the scene's geometry and grid bounds, one step's point sets
    (``batch``), the bias-correction tables of the scene's steps, the
    device step counter that indexes them, every step's loss
    (``losses [steps]``) and the last step's terms (``aux``). A scene
    copies its inputs in, runs :meth:`step` once per step (with capture: a
    replay of its graph), and copies the decoders and grids out. The
    learning rates are constants of the step."""

    def __init__(self, programs: Programs, device: torch.device, cfg: PretrainConfig,
                 decoders, grids, geom, grid_bounds):
        self.programs, self.device, self.cfg = programs, device, cfg
        self.decoders = trainable(clone_tree(decoders))
        self.grids = trainable(clone_tree(grids))
        self.leaves = trainable_leaves(self.decoders, self.grids)
        n_dec = len(self.leaves) - len(self.grids)
        self.lrs = [cfg.decoders_lr] * n_dec + [cfg.grids_lr] * len(self.grids)
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.geom, self.grid_bounds = clone_tree(geom), clone_tree(grid_bounds)
        self.batch = empty_batch(cfg.batch, device)
        self.c1, self.c2 = bias_corrections(cfg.steps, device)
        self.losses = torch.zeros((cfg.steps,), device=device)
        self.counter = torch.zeros((1,), dtype=torch.long, device=device)
        self.aux: Optional[Dict[str, torch.Tensor]] = None
        self.graph: Optional[tuple] = None

    def step(self) -> None:
        """Step ``counter`` on ``batch``: the loss and its gradients, the
        Adam step of every leaf at the counter's bias corrections, the loss
        into ``losses``, the terms into ``aux``, then the counter + 1."""
        total, aux, grads = loss_and_grads(self.decoders, self.grids, self.batch, self.geom,
                                           self.grid_bounds, self.cfg)
        c1, c2 = (t.index_select(0, self.counter) for t in (self.c1, self.c2))
        with torch.no_grad():
            for p, g, m, v, lr in zip(self.leaves, grads, self.mu, self.nu, self.lrs):
                adam_moments_(m, v, g)  # g None: zero by construction, the moments decay
                p.sub_(lr * adam_direction(m, v, c1, c2))
            self.losses.index_copy_(0, self.counter, total.detach().reshape(1))
            if self.aux is None:  # the first call: eager, or a capture's warm-up
                self.aux = {k: t.detach().clone() for k, t in aux.items()}
            else:
                _copy_dict_(self.aux, aux)
            self.counter.add_(1)

    def load(self, decoders, grids, geom, grid_bounds) -> None:
        """Copy a scene's inputs in, zero the moments (the script's
        per-scene ``tx.init``) and the counter."""
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(self.decoders), tree_leaves(decoders))
            for dst, src in ((self.grids, grids), (self.geom, geom),
                             (self.grid_bounds, grid_bounds)):
                _copy_dict_(dst, src)
            torch._foreach_zero_(self.mu + self.nu)
            self.counter.zero_()

    def buffers(self) -> List[torch.Tensor]:
        """What a step writes: the leaves, the moments, the losses, the
        counter and (once the first step made them) the terms."""
        aux = [] if self.aux is None else list(self.aux.values())
        return [*self.leaves, *self.mu, *self.nu, self.losses, self.counter, *aux]

    def _graph(self):
        if self.graph is None:
            self.graph = self.programs.capture_graph(
                self.device,
                f"pretrain step batch={self.cfg.batch} fine={tuple(self.grids['fine'].shape)} "
                f"route={get_sampler_route()} {self.device}",
                self.step, self.buffers)
        return self.graph

    def warm(self, decoders, grids, geom, grid_bounds) -> None:
        """Capture the graph (with capture on) on a scene's inputs, without
        stepping."""
        self.load(decoders, grids, geom, grid_bounds)
        if self.programs.capture:
            self._graph()

    def run(self, decoders, grids, geom, grid_bounds, gen, batches):
        """One scene: ``cfg.steps`` steps, each on a batch drawn from ``gen``
        or ``batches[step]`` and copied into ``batch``; then the decoders
        and grids copied back into the arguments, in place. Returns new
        tensors ``(losses, aux)``."""
        self.load(decoders, grids, geom, grid_bounds)
        with self.programs._device_context(self.device):
            for step in range(self.cfg.steps):
                batch = (batches[step] if batches is not None
                         else draw_batch(gen, geom, grid_bounds, self.cfg.batch))
                with torch.no_grad():
                    _copy_dict_(self.batch, batch)
                if self.programs.capture:
                    graph, delta = self._graph()
                    graph.replay()
                    add_replays(delta, 1)
                else:
                    self.step()
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(decoders), tree_leaves(self.decoders))
            _copy_dict_(grids, self.grids)
        return self.losses.clone(), {k: t.clone() for k, t in self.aux.items()}


def empty_batch(batch: int, device) -> Batch:
    """Zeros in the shapes of :func:`draw_batch`'s point sets at ``batch``."""
    n_per = max(batch // (2 * N_OBS), 1)
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"p_uni": z(batch, 3), "p_room": z(batch // 2, 3),
            "f_room": torch.zeros((batch // 2,), dtype=torch.long, device=device),
            "p_obs": z(N_OBS * n_per, 3), "p_c": z(batch, 3)}


def scene_program(programs: Programs, decoders, grids, geom, grid_bounds,
                  cfg: PretrainConfig) -> PretrainProgram:
    """The step's program for these grids' shapes (one per bound envelope)
    in ``programs``, made on first use."""
    device = indexed_device(grids["fine"].device)
    key = (device, get_sampler_route(), cfg, tuple(tuple(g.shape) for g in grids.values()))
    prog = programs.pretraining.get(key)
    if prog is None:
        prog = programs.pretraining[key] = PretrainProgram(
            programs, device, cfg, decoders, grids, geom, grid_bounds)
    return prog


def train_scene(decoders, grids: Dict[str, torch.Tensor], geom: Dict[str, torch.Tensor],
                grid_bounds: Dict[str, torch.Tensor], cfg: PretrainConfig,
                gen: Optional[torch.Generator] = None,
                batches: Optional[Sequence[Batch]] = None, capture: Optional[bool] = None,
                programs: Optional[Programs] = None):
    """``cfg.steps`` Adam steps on one scene, in place on ``decoders`` and
    ``grids`` (leaves that require grad), with fresh moments for both, as the
    script's per-scene ``tx.init``. Each step draws from ``gen``, or takes
    ``batches[step]``. Returns the loss of every step ``[steps]`` and the last
    step's ``aux``, still on the device: nothing here waits for it.

    The steps run as the :class:`PretrainProgram` of the grids' shapes in
    ``programs`` (by default the process-wide programs of ``capture``, which
    follows ``NiceSLAM``'s rule: graphs on a card unless ``False``, only to
    compare the two; ``True`` on the CPU raises)."""
    if programs is None:
        programs = shared_programs(grids["fine"].device, capture)
    prog = scene_program(programs, decoders, grids, geom, grid_bounds, cfg)
    return prog.run(decoders, grids, geom, grid_bounds, gen, batches)


def trainable(tree):
    """``tree``'s tensors as leaves that require grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def pretrain(cfg: PretrainConfig, device="cuda", capture: Optional[bool] = None):
    """The whole recipe on ``device``: returns the trained decoders and, per
    scene, ``{"scene", "bound", "first", "last", "aux", "s_per_step"}``
    (and ``peak_mib`` on a card, ``pool_mib`` with graphs), each also
    printed to standard error as ``scene S (bound B) {json}``, with its
    ``losses`` kept off that line. ``capture`` as ``NiceSLAM``'s: graphs on
    a card by default, ``False`` only to compare the two. The step of an
    envelope is captured before its first scene (``graph SIGNATURE {json}``
    on standard error: seconds, nodes, launches per replay)."""
    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    decoders = trainable(init_decoders(
        DecoderConfig(), gen=torch.Generator().manual_seed(cfg.seed + 1), device=device))
    on_card = torch.device(device).type == "cuda"
    programs = Programs(resolve_capture(capture, [device]))
    records = []
    for s in range(cfg.scenes):
        bi = s % len(BOUND_SET)
        grids, grid_bounds, adj_bound = init_grids(
            np.asarray(BOUND_SET[bi], np.float32), GridConfig(),
            gen=torch.Generator().manual_seed(cfg.seed + 100 + s), device=device)
        grids = trainable(grids)
        geom = {k: torch.from_numpy(v).to(device)
                for k, v in scene_geometry(rng, adj_bound).items()}
        n_captured = len(programs.captures)
        scene_program(programs, decoders, grids, geom, grid_bounds, cfg).warm(
            decoders, grids, geom, grid_bounds)
        for c in programs.captures[n_captured:]:
            print(f"graph {c.signature} " + json.dumps(
                {"seconds": c.seconds, "nodes": c.nodes, "launches": c.launches}),
                file=sys.stderr, flush=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        losses, aux = train_scene(decoders, grids, geom, grid_bounds, cfg, gen,
                                  programs=programs)
        losses = losses.cpu().numpy()  # the scene's one wait for the device
        dt = time.perf_counter() - t0
        rec = {"scene": s, "bound": bi, "first": float(losses[0]), "last": float(losses[-1]),
               "aux": {k: float(v) for k, v in aux.items()}, "s_per_step": dt / cfg.steps}
        if on_card:
            rec["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
            if programs.capture:
                rec["pool_mib"] = pool_bytes([indexed_device(device)]) / 2**20
        if not np.isfinite(losses[-1]):
            raise FloatingPointError(f"scene {s} diverged: loss {losses[-1]}")
        print(f"scene {s} (bound {bi}) {json.dumps(rec)}", file=sys.stderr, flush=True)
        rec["losses"] = losses
        records.append(rec)
    return decoders, records


def parse_args(argv=None):
    d = PretrainConfig()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=d.scenes)
    ap.add_argument("--steps", type=int, default=d.steps, help="optimization steps per scene")
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--decoders-lr", type=float, default=d.decoders_lr)
    ap.add_argument("--grids-lr", type=float, default=d.grids_lr)
    ap.add_argument("--width", type=float, default=d.width,
                    help="occupancy transition half-width [m] (middle/fine)")
    ap.add_argument("--width-coarse", type=float, default=d.width_coarse)
    ap.add_argument("--cal-target", type=float, default=d.cal_target)
    ap.add_argument("--out", default=d.out)
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    a = ap.parse_args(argv)
    cfg = PretrainConfig(**{k: getattr(a, k) for k in PretrainConfig._fields})
    return cfg, "cpu" if a.cpu else "cuda"


def main(argv=None) -> int:
    cfg, device = parse_args(argv)
    if os.path.realpath(cfg.out) == os.path.realpath(SHIPPED):
        raise ValueError(f"--out {cfg.out} is the shipped decoders' file; choose another path")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to train on the CPU")
    t0 = time.perf_counter()
    decoders, records = pretrain(cfg, device)
    os.makedirs(os.path.dirname(cfg.out) or ".", exist_ok=True)
    save_decoders_npz(cfg.out, decoders)
    print(json.dumps({
        "scenes": cfg.scenes,
        "steps_per_scene": cfg.steps,
        "final_losses": {k: round(v, 4) for k, v in records[-1]["aux"].items()},
        "wall_s": round(time.perf_counter() - t0, 1),
        "out": cfg.out,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
