"""Mapper: staged joint optimization of grids + decoders (+ poses under BA).

One mapping pass runs a per-iteration schedule: stage ids (middle <= 40 %
-> fine <= 60 % -> color, or coarse for the coarse pass) and per-group
learning rates for grids, decoders and window cameras. Each iteration draws
a fresh ray batch over the valid window frames, evaluates the stage's
:func:`mapping_loss`, differentiates it and applies a hand-written Adam step
that matches ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias
correction, one shared step count):

- moments come from the UNMASKED gradients of every leaf that some stage of
  the pass trains (a leaf a stage does not touch gets a zero gradient and
  its moments decay);
- the frustum mask and the per-group learning rate multiply the update;
- an inactive schedule row is skipped: params, moments and count stay put.

Leaves that no stage of the pass trains (``freeze_for_stage``: the union
over stages) are not differentiated at all: their moments would stay zero
and their update zero.

One iteration is :func:`mapping_iteration`. What changes from row to row
(the learning rates, Adam's bias corrections, the pixel draws) sits in
device tables (:class:`PassTables`) indexed by a device step counter, as
the JAX program's traced schedule, so that one captured CUDA graph of an
iteration serves every row of its stage (``slam/programs.py``). The host
knows only the stage and which learning rates are 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.schema import StageLR
from ..core.pose import camera_from_tensor, to_homogeneous
from ..core.rays import Intrinsics, pixel_dirs
from ..core.transfer import to_device
from ..models.decoders import tree_leaves, tree_map
from ..render.renderer import RenderConfig, render_rays

STAGE_ORDER = ("coarse", "middle", "fine", "color")
LEVEL_ORDER = ("coarse", "middle", "fine", "color")

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class MapOptConfig(NamedTuple):
    """Knobs of one mapping pass (consumed by the schedule builder)."""

    pixels: int = 1000
    w_color_loss: float = 0.2
    BA: bool = False
    BA_cam_lr: float = 1e-3
    fix_fine: bool = True
    fix_color: bool = False
    frustum_feature_selection: bool = True
    lr_factor: float = 1.0
    train_all_decoders: bool = False
    decoders_lr_fallback: float = 0.005
    tv_weight: float = 0.0  # ProgConfig.tv_weight, for optimize_window
    fs_weight: float = 0.0  # ProgConfig.fs_weight, for optimize_window
    fs_band: float = 0.05


class ProgConfig(NamedTuple):
    """What one pass's iterations need besides the schedule rows.

    ``dec_train`` is the [stage][level] decoder-trainability table
    (STAGE_ORDER x LEVEL_ORDER); ``ba`` keeps the window cameras
    differentiable."""

    n_pixels: int
    w_color_loss: float
    frustum: bool
    dec_train: Tuple[Tuple[bool, bool, bool, bool], ...]
    ba: bool = False
    tv_weight: float = 0.0
    fs_weight: float = 0.0
    fs_band: float = 0.05


class Schedule(NamedTuple):
    """Per-iteration schedule rows (host numpy)."""

    iter_idx: np.ndarray  # [n] int32 — global iteration within the pass
    stage_ids: np.ndarray  # [n] int32 — index into STAGE_ORDER
    lr_grids: np.ndarray  # [n, 4] — per grid level (LEVEL_ORDER)
    lr_dec: np.ndarray  # [n, 4] — per decoder level
    lr_cam: np.ndarray  # [n] — camera-tensor lr (BA; 0 otherwise)
    active: np.ndarray  # [n] bool — False on pad rows: step skipped

    def __len__(self):
        return self.stage_ids.shape[0]


StagePlan = Tuple[Tuple[str, int, StageLR], ...]


def build_stage_plan(
    num_joint_iters: int,
    middle_iter_ratio: float,
    fine_iter_ratio: float,
    cfg_stage_lr,
    coarse: bool = False,
) -> StagePlan:
    """Split the iteration budget: iteration i is middle if i <= int(N*mr),
    fine if i <= int(N*fr), else color; the coarse pass is all coarse."""
    n = num_joint_iters
    if coarse:
        return (("coarse", n, cfg_stage_lr("coarse")),)
    n_mid = min(int(n * middle_iter_ratio) + 1, n)
    n_fine = max(min(int(n * fine_iter_ratio) + 1, n) - n_mid, 0)
    n_color = n - n_mid - n_fine
    plan = []
    if n_mid:
        plan.append(("middle", n_mid, cfg_stage_lr("middle")))
    if n_fine:
        plan.append(("fine", n_fine, cfg_stage_lr("fine")))
    if n_color:
        plan.append(("color", n_color, cfg_stage_lr("color")))
    return tuple(plan)


def _grid_lr(level: str, lrs: StageLR) -> float:
    return getattr(lrs, f"{level}_lr")


def _decoder_lr(level: str, lrs: StageLR, cfg: MapOptConfig) -> float:
    if cfg.train_all_decoders:
        if level == "color" and cfg.fix_color:
            return 0.0
        return lrs.decoders_lr if lrs.decoders_lr > 0 else cfg.decoders_lr_fallback
    if level == "fine" and not cfg.fix_fine:
        return lrs.decoders_lr
    if level == "color" and not cfg.fix_color:
        return lrs.decoders_lr
    return 0.0


def dec_train_table(stage_lr_fn, cfg: MapOptConfig):
    """[stage][level] decoder trainability from the full stage-LR table."""
    return tuple(
        tuple(_decoder_lr(lvl, stage_lr_fn(stage), cfg) != 0.0 for lvl in LEVEL_ORDER)
        for stage in STAGE_ORDER
    )


def dec_train_from_plan(plan: StagePlan, cfg: MapOptConfig):
    """Like :func:`dec_train_table` but from one pass's plan: the rows of
    stages absent from the plan are all False."""
    by_stage = {stage: lrs for stage, _, lrs in plan}
    return tuple(
        tuple(
            stage in by_stage and _decoder_lr(lvl, by_stage[stage], cfg) != 0.0
            for lvl in LEVEL_ORDER
        )
        for stage in STAGE_ORDER
    )


def schedule_arrays(plan: StagePlan, cfg: MapOptConfig, offset: int = 0) -> Schedule:
    """Expand a stage plan into per-iteration schedule rows."""
    sid, lg, ld, lc = [], [], [], []
    f = cfg.lr_factor
    for stage, n_iters, lrs in plan:
        g_row = [_grid_lr(lvl, lrs) * f for lvl in LEVEL_ORDER]
        d_row = [_decoder_lr(lvl, lrs, cfg) * f for lvl in LEVEL_ORDER]
        c = cfg.BA_cam_lr if (cfg.BA and stage == "color") else 0.0
        for _ in range(n_iters):
            sid.append(STAGE_ORDER.index(stage))
            lg.append(g_row)
            ld.append(d_row)
            lc.append(c)
    n = len(sid)
    return Schedule(
        iter_idx=np.arange(offset, offset + n, dtype=np.int32),
        stage_ids=np.asarray(sid, np.int32),
        lr_grids=np.asarray(lg, np.float32).reshape(n, 4),
        lr_dec=np.asarray(ld, np.float32).reshape(n, 4),
        lr_cam=np.asarray(lc, np.float32),
        active=np.ones((n,), bool),
    )


@lru_cache(maxsize=64)
def chunked_schedule(
    plan: StagePlan, cfg: MapOptConfig, chunk_size: int
) -> Tuple[Tuple[Schedule, ...], Tuple[int, ...]]:
    """The plan as chunks of ``chunk_size`` rows, the last padded with
    inactive rows; returns ``(chunks, real_lengths)``."""
    full = schedule_arrays(plan, cfg)
    chunks, reals = [], []
    for s0 in range(0, len(full), chunk_size):
        part = Schedule(*(x[s0:s0 + chunk_size] for x in full))
        real = len(part)
        p = chunk_size - real
        if p:
            part = Schedule(
                iter_idx=np.concatenate(
                    [part.iter_idx, part.iter_idx[-1] + 1 + np.arange(p, dtype=np.int32)]
                ),
                stage_ids=np.concatenate([part.stage_ids, np.zeros((p,), np.int32)]),
                lr_grids=np.concatenate([part.lr_grids, np.zeros((p, 4), np.float32)]),
                lr_dec=np.concatenate([part.lr_dec, np.zeros((p, 4), np.float32)]),
                lr_cam=np.concatenate([part.lr_cam, np.zeros((p,), np.float32)]),
                active=np.concatenate([part.active, np.zeros((p,), bool)]),
            )
        chunks.append(part)
        reals.append(real)
    return tuple(chunks), tuple(reals)


# ------------------------------------------------------------------ the loss
def draw_mapping_pixels(
    gen: Optional[torch.Generator],
    valid_idx: torch.Tensor,
    n: int,
    intr: Intrinsics,
    device,
):
    """``(fidx, i, j)``: each ray's window frame uniformly over the valid
    slots ``valid_idx``, and a uniform pixel."""
    k = torch.randint(0, len(valid_idx), (n,), generator=gen, device=device)
    j = torch.randint(0, intr.H, (n,), generator=gen, device=device)
    i = torch.randint(0, intr.W, (n,), generator=gen, device=device)
    return valid_idx[k], i, j


def mapping_rays(
    cams,  # [F, 7] camera tensors
    intr: Intrinsics,
    colors,  # [F, H, W, 3]
    depths,  # [F, H, W]
    frame_valid,  # [F] bool tensor
    cam_fixed,  # [F] bool tensor — pose receives no gradient
    fidx, i, j,  # [N] ray frame slots, pixel columns, pixel rows
    ray_shard: Optional[Tuple[int, int]] = None,
):
    """The rays of :func:`mapping_loss` (its ``ray_shard`` slice of the
    draw): ``(rays_o, rays_d, gt_depth, gt_color, ray_w)``, the rays
    differentiable in the cameras that are not fixed."""
    if ray_shard is not None:
        start, size = ray_shard
        fidx, i, j = (t[start:start + size] for t in (fidx, i, j))
    cams = torch.where(cam_fixed[:, None], cams.detach(), cams)
    c2ws = to_homogeneous(camera_from_tensor(cams))  # [F, 4, 4]
    dirs = pixel_dirs(intr, i.to(torch.float32), j.to(torch.float32))
    rays_o = c2ws[fidx, :3, 3]
    rays_d = torch.einsum("nij,nj->ni", c2ws[fidx, :3, :3], dirs)
    gt_depth = depths[fidx, j, i]
    gt_color = colors[fidx, j, i]
    ray_w = frame_valid[fidx].to(torch.float32)
    return rays_o, rays_d, gt_depth, gt_color, ray_w


def mapping_loss(
    all_params,
    bounds,
    scene_bound,
    intr: Intrinsics,
    colors,  # [F, H, W, 3]
    depths,  # [F, H, W]
    frame_valid,  # [F] bool tensor
    cam_fixed,  # [F] bool tensor — pose receives no gradient
    fidx, i, j,  # [N] ray frame slots, pixel columns, pixel rows
    stage: str,
    w_color_loss: float,
    rcfg: RenderConfig,
    tv_weight: float = 0.0,
    fs_weight: float = 0.0,
    fs_band: float = 0.05,
    ray_shard: Optional[Tuple[int, int]] = None,
):
    """One joint-iteration loss over the keyframe window: per-ray depth L1
    over gt > 0 pixels, the free-space occupancy term, the color L1 in the
    color stage, and the optional TV term. Rays originate from the current
    camera tensors, so BA gradients reach the poses through the sampler's
    coordinate gradients.

    ``ray_shard=(start, size)`` evaluates only rays ``[start, start + size)``
    of the draw ``(fidx, i, j)``: every rank of the sharded mapping program
    (``parallel/sharded_mapper.py``) passes the whole draw and its slice, so
    the slices over the ``kf`` axis are the unsharded ray set, and their
    losses (sums over rays) add up to the unsharded loss."""
    grids, decoders = all_params["grids"], all_params["decoders"]
    rays_o, rays_d, gt_depth, gt_color, ray_w = mapping_rays(
        all_params["cams"], intr, colors, depths, frame_valid, cam_fixed, fidx, i, j,
        ray_shard)
    out = render_rays(
        decoders, grids, bounds, scene_bound, rays_o, rays_d, gt_depth, stage, rcfg
    )
    depth_mask = (gt_depth > 0).to(torch.float32) * ray_w
    loss = torch.sum(torch.abs(gt_depth - out.depth) * depth_mask)
    if fs_weight > 0.0:
        band = fs_band * (6.0 if stage == "coarse" else 1.0)
        tgt = torch.tanh((out.z_vals - gt_depth[:, None]) / band)
        m = depth_mask[:, None] * out.sample_valid.to(torch.float32)
        per = torch.square(out.occ - tgt) * m
        loss = loss + fs_weight * torch.sum(per) / out.occ.shape[-1]
    if stage == "color":
        closs = torch.sum(torch.abs(gt_color - out.rgb) * ray_w[:, None])
        loss = loss + w_color_loss * closs
    if tv_weight > 0.0:
        tv = 0.0
        for lvl in ("middle", "fine"):
            g = grids[lvl]
            tv = tv + (
                torch.mean(torch.square(g[1:] - g[:-1]))
                + torch.mean(torch.square(g[:, 1:] - g[:, :-1]))
                + torch.mean(torch.square(g[:, :, 1:] - g[:, :, :-1]))
            )
        loss = loss + tv_weight * tv
    return loss


# ---------------------------------------------------------------- optimizer
def freeze_for_stage(pcfg: ProgConfig) -> Dict[str, object]:
    """Which leaves the pass differentiates: every grid, the decoder levels
    that train in ANY stage of the table (the union over stages), and the
    cameras under BA."""
    any_train = [any(row[k] for row in pcfg.dec_train) for k in range(len(LEVEL_ORDER))]
    return {
        "decoders": {lvl: any_train[k] for k, lvl in enumerate(LEVEL_ORDER)},
        "cams": pcfg.ba,
    }


@dataclass
class AdamState:
    """``optax.scale_by_adam`` state over a pass's trainable leaves.
    ``count`` is the host's count of the steps taken; a step reads its bias
    corrections from a device table (:func:`bias_corrections`)."""

    count: int = 0
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


@dataclass
class PassParams:
    """One pass's parameters, flattened into trainable leaves with their
    learning-rate group (``("grids", level)``, ``("decoders", level)`` or
    ``("cams", None)``) and optional update mask."""

    params: Dict
    leaves: List[torch.Tensor]
    groups: List[Tuple[str, Optional[str]]]


def make_pass_params(grids, decoders, cams, pcfg: ProgConfig) -> PassParams:
    """Fresh leaves for a pass (the inputs are cloned, never modified), with
    ``requires_grad`` on exactly the leaves the pass trains."""
    frz = freeze_for_stage(pcfg)
    g2 = {k: v.detach().clone() for k, v in grids.items()}
    d2 = {
        lvl: _clone_tree(sub) for lvl, sub in decoders.items()
    }
    c2 = cams.detach().clone()
    leaves, groups = [], []
    for lvl, g in g2.items():
        g.requires_grad_(True)
        leaves.append(g)
        groups.append(("grids", lvl))
    for lvl, sub in d2.items():
        if frz["decoders"].get(lvl, False):
            for t in tree_leaves(sub):
                t.requires_grad_(True)
                leaves.append(t)
                groups.append(("decoders", lvl))
    if frz["cams"]:
        c2.requires_grad_(True)
        leaves.append(c2)
        groups.append(("cams", None))
    return PassParams({"grids": g2, "decoders": d2, "cams": c2}, leaves, groups)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone()


def init_opt_state(pp: PassParams) -> AdamState:
    return AdamState(
        0,
        [torch.zeros_like(t) for t in pp.leaves],
        [torch.zeros_like(t) for t in pp.leaves],
    )


def adam_moments_(mu: torch.Tensor, nu: torch.Tensor, g: Optional[torch.Tensor]) -> None:
    """``scale_by_adam``'s moment updates in place; ``g=None`` is a zero
    gradient (the moments only decay)."""
    if g is None:
        mu.mul_(ADAM_B1)
        nu.mul_(ADAM_B2)
    else:
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)


def bias_corrections(n: int, device, start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scale_by_adam``'s bias corrections of steps ``start + 1`` to
    ``start + n`` as two float32 tables ``[n]`` on ``device``, in the form
    :func:`adam_direction` takes them: ``1 - b**count`` on the CPU, its
    float32 reciprocal on a card.

    The corrections are float32, as optax computes them (``1 - b2`` in
    float32 differs from the float64 value by ~1e-5 relative at count 1).
    The form keeps the bits of dividing by a host float: PyTorch's CUDA
    ``div`` by a host scalar multiplies by the scalar's float32 reciprocal,
    its CPU ``div`` divides."""
    reciprocal = torch.device(device).type == "cuda"
    one = np.float32(1.0)
    tables = ([], [])
    for count in range(start + 1, start + n + 1):
        for b, out in zip((ADAM_B1, ADAM_B2), tables):
            c = one - np.float32(b) ** np.float32(count)
            out.append(one / c if reciprocal else c)
    return tuple(to_device(np.asarray(t, np.float32), device) for t in tables)


def adam_direction(mu: torch.Tensor, nu: torch.Tensor, c1: torch.Tensor,
                   c2: torch.Tensor) -> torch.Tensor:
    """``scale_by_adam``'s bias-corrected update, ``c1`` and ``c2`` the
    step's entries of the :func:`bias_corrections` tables."""
    if mu.device.type == "cuda":
        return (mu * c1) / (torch.sqrt(nu * c2) + ADAM_EPS)
    return (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)


# Columns of a pass's learning-rate table: the grid levels, the decoder
# levels (LEVEL_ORDER each), the window cameras.
LR_COLUMNS = 2 * len(LEVEL_ORDER) + 1


def lr_column(kind: str, lvl: Optional[str]) -> int:
    """The learning-rate column of a leaf's group."""
    if kind == "grids":
        return LEVEL_ORDER.index(lvl)
    if kind == "decoders":
        return len(LEVEL_ORDER) + LEVEL_ORDER.index(lvl)
    return LR_COLUMNS - 1


def schedule_lrs(sched: Schedule) -> np.ndarray:
    """The schedule's learning rates as one float32 table ``[rows,
    LR_COLUMNS]``."""
    return np.concatenate(
        [sched.lr_grids, sched.lr_dec, sched.lr_cam[:, None]], axis=1
    ).astype(np.float32)


def lr_zero(lrs_row: np.ndarray) -> Tuple[bool, ...]:
    """Which learning-rate columns of a row are 0: a leaf whose learning
    rate is 0 is not stepped (its moments still are)."""
    return tuple(bool(z) for z in np.asarray(lrs_row) == 0)


@torch.no_grad()
def adam_step(
    pp: PassParams,
    grads: List[Optional[torch.Tensor]],
    state: AdamState,
    lrs: torch.Tensor,
    c1: torch.Tensor,
    c2: torch.Tensor,
    grid_masks: Optional[Dict[str, torch.Tensor]],
    zero: Tuple[bool, ...],
) -> None:
    """One ``scale_by_adam`` step on unmasked grads, then ``p -= lr * update
    * mask`` per group, in place: ``lrs [1, LR_COLUMNS]`` is the step's
    learning-rate row and ``c1``, ``c2`` its bias corrections, all on the
    device; ``zero`` is :func:`lr_zero` of the row, known to the host."""
    for p, g, mu, nu, (kind, lvl) in zip(
        pp.leaves, grads, state.mu, state.nu, pp.groups
    ):
        adam_moments_(mu, nu, g)  # g None: a leaf this stage does not touch
        col = lr_column(kind, lvl)
        if zero[col]:
            continue
        upd = adam_direction(mu, nu, c1, c2)
        if kind == "grids" and grid_masks is not None:
            upd = upd * grid_masks[lvl]
        p.sub_(lrs[:, col] * upd)


def adam_update(
    pp: PassParams,
    grads: List[Optional[torch.Tensor]],
    state: AdamState,
    lr_grids: np.ndarray,
    lr_dec: np.ndarray,
    lr_cam: float,
    grid_masks: Optional[Dict[str, torch.Tensor]],
) -> None:
    """:func:`adam_step` at host learning rates, the next step of ``state``."""
    dev = pp.leaves[0].device
    lrs = np.concatenate([lr_grids, lr_dec, [lr_cam]]).astype(np.float32)[None]
    c1, c2 = bias_corrections(1, dev, start=state.count)
    state.count += 1
    adam_step(pp, grads, state, to_device(lrs, dev), c1, c2, grid_masks, lr_zero(lrs[0]))


# ------------------------------------------------------------ one iteration
class PassInputs(NamedTuple):
    """What a pass's iterations read besides its parameters and tables."""

    bounds: Dict[str, torch.Tensor]
    scene_bound: torch.Tensor
    colors: torch.Tensor  # [F, H, W, 3]
    depths: torch.Tensor  # [F, H, W]
    frame_valid: torch.Tensor  # [F] bool
    cam_fixed: torch.Tensor  # [F] bool: the pose receives no gradient
    masks: Optional[Dict[str, torch.Tensor]]  # update masks [Z, Y, X, 1], or None


class PassTables(NamedTuple):
    """A pass's per-row device tables and the device step counter that
    indexes them: an iteration reads row ``step`` and advances it, so one
    captured iteration serves every row (``slam/programs.py``)."""

    lrs: torch.Tensor  # [rows, LR_COLUMNS] float32 (schedule_lrs)
    c1: torch.Tensor  # [rows] bias corrections of counts 1.. (bias_corrections)
    c2: torch.Tensor
    pixels: torch.Tensor  # [rows, 3, n_pixels] int64: each row's (fidx, i, j)
    losses: torch.Tensor  # [rows] float32, each row's loss
    step: torch.Tensor  # [1] int64


def new_pass_tables(rows: int, n_pixels: int, device, count0: int = 0) -> PassTables:
    """Tables for ``rows`` rows whose first Adam count is ``count0 + 1``."""
    c1, c2 = bias_corrections(rows, device, start=count0)
    return PassTables(
        lrs=torch.zeros((rows, LR_COLUMNS), dtype=torch.float32, device=device),
        c1=c1,
        c2=c2,
        pixels=torch.zeros((rows, 3, n_pixels), dtype=torch.long, device=device),
        losses=torch.zeros((rows,), dtype=torch.float32, device=device),
        step=torch.zeros((1,), dtype=torch.long, device=device),
    )


def stack_draws(draws, device) -> torch.Tensor:
    """Per-row draws (sequences of index tensors) as one int64 table
    ``[rows, k, n]`` on ``device``."""
    return torch.stack([
        torch.stack([t.to(device=device, dtype=torch.long) for t in d]) for d in draws
    ])


@torch.no_grad()
def start_pass(tab: PassTables, lrs: np.ndarray, pixels: torch.Tensor) -> None:
    """Fill the first rows of ``tab`` for a pass (learning rates ``[n,
    LR_COLUMNS]``, draws ``[n, 3, n_pixels]``) and set its step to 0."""
    n = lrs.shape[0]
    tab.lrs[:n].copy_(to_device(lrs, tab.lrs.device))
    tab.pixels[:n].copy_(pixels)
    tab.step.zero_()


class KfSlice(NamedTuple):
    """What a rank of a ``('map', 'kf')`` mesh changes in an iteration
    (``parallel/sharded_mapper.py``): the rays it evaluates of each row's
    draw (``mapping_loss``'s ``ray_shard``), ``tv_term(grids)`` in the place
    of ``mapping_loss``'s TV sum, and ``reduce(flat)``, which sums a flat
    buffer laid out by :func:`pack_grads_` in place over the kf group (None
    with one kf rank). ``key`` is the rank's place in its mesh. With more
    than one map block, ``segments(program)`` makes the iteration of a
    ``slam.programs.MappingProgram`` as segments between collectives
    (``sharded_mapper.MapSegments``); None with one map block."""

    ray_shard: Tuple[int, int]
    tv_term: Callable
    reduce: Optional[Callable]
    key: tuple
    segments: Optional[Callable] = None


class Segment(NamedTuple):
    """A part of a mapping iteration that one CUDA graph can hold: ``body``
    reads and writes static buffers only; ``before``, when given, is the
    collective that runs eagerly between the previous segment and this one.
    ``name`` names the segment's graph in the capture records."""

    name: str
    body: Callable[[], None]
    before: Optional[Callable[[], None]] = None


def new_flat(leaves: List[torch.Tensor]) -> torch.Tensor:
    """A flat float32 buffer with room for a loss and a gradient of every
    leaf (:func:`pack_grads_`)."""
    return torch.zeros((1 + sum(t.numel() for t in leaves),), dtype=torch.float32,
                       device=leaves[0].device)


def flat_views(flat: torch.Tensor, leaves: List[torch.Tensor], has_grad):
    """``(loss, grads, used)``: views of ``flat`` laid out with the loss
    first, then the gradient of every leaf whose ``has_grad`` is true, in
    leaf order (``None`` for the others), and the length they use."""
    grads, k = [], 1
    for t, live in zip(leaves, has_grad):
        if not live:
            grads.append(None)
            continue
        grads.append(flat[k:k + t.numel()].view(t.shape))
        k += t.numel()
    return flat[0], grads, k


@torch.no_grad()
def pack_grads_(flat: torch.Tensor, loss: torch.Tensor, grads: List[Optional[torch.Tensor]]):
    """Write ``loss`` and the gradients that are not ``None`` into ``flat``
    (:func:`flat_views`' layout); returns ``(loss, grads, used)`` as views of
    ``flat``. ``None`` (a leaf the stage does not reach) stays ``None``."""
    v_loss, v_grads, used = flat_views(flat, grads, [g is not None for g in grads])
    live = [(v, g) for v, g in zip(v_grads, grads) if g is not None]
    torch._foreach_copy_([v_loss] + [v for v, _ in live], [loss] + [g for _, g in live])
    return v_loss, v_grads, used


def mapping_grads(
    pp: PassParams,
    tab: PassTables,
    inp: PassInputs,
    intr: Intrinsics,
    pcfg: ProgConfig,
    rcfg: RenderConfig,
    stage: str,
    kf: Optional[KfSlice] = None,
    flat: Optional[torch.Tensor] = None,
):
    """The first half of row ``tab.step``: that row's draws, the stage's
    loss (on ``kf``'s ray slice with its TV term) and its gradients; returns
    ``(loss, grads)``. With ``flat`` they are written into it
    (:func:`pack_grads_`) and returned as its views, ``(loss, grads,
    used)``."""
    fidx, i, j = tab.pixels.index_select(0, tab.step)[0]
    loss = mapping_loss(
        pp.params, inp.bounds, inp.scene_bound, intr, inp.colors, inp.depths,
        inp.frame_valid, inp.cam_fixed, fidx, i, j, stage, pcfg.w_color_loss, rcfg,
        tv_weight=0.0 if kf is not None else pcfg.tv_weight,
        fs_weight=pcfg.fs_weight, fs_band=pcfg.fs_band,
        ray_shard=None if kf is None else kf.ray_shard,
    )
    if kf is not None and pcfg.tv_weight > 0.0:
        loss = loss + pcfg.tv_weight * kf.tv_term(pp.params["grids"])
    grads = list(torch.autograd.grad(loss, pp.leaves, allow_unused=True))
    if flat is None:
        return loss, grads
    return pack_grads_(flat, loss.detach(), grads)


def mapping_step(
    pp: PassParams,
    opt_state: AdamState,
    tab: PassTables,
    inp: PassInputs,
    loss: torch.Tensor,
    grads: List[Optional[torch.Tensor]],
    zero: Tuple[bool, ...],
) -> None:
    """The second half of row ``tab.step``: the Adam step on ``grads`` at
    the row's learning rates, ``loss`` into ``tab.losses``, then the step
    counter + 1."""
    row = (t.index_select(0, tab.step) for t in (tab.lrs, tab.c1, tab.c2))
    adam_step(pp, grads, opt_state, *row, inp.masks, zero)
    with torch.no_grad():
        tab.losses.index_copy_(0, tab.step, loss.detach().reshape(1))
        tab.step.add_(1)


def mapping_iteration(
    pp: PassParams,
    opt_state: AdamState,
    tab: PassTables,
    inp: PassInputs,
    intr: Intrinsics,
    pcfg: ProgConfig,
    rcfg: RenderConfig,
    stage: str,
    zero: Tuple[bool, ...],
    kf: Optional[KfSlice] = None,
    flat: Optional[torch.Tensor] = None,
) -> None:
    """Row ``tab.step`` of a pass, in place on ``pp``, ``opt_state`` and
    ``tab``: :func:`mapping_grads`, then on a kf mesh ``kf.reduce`` of the
    loss and gradients in ``flat`` (a :func:`new_flat` of ``pp.leaves``),
    then :func:`mapping_step`. ``stage`` and ``zero`` (:func:`lr_zero` of the
    row) are what the host must know; every value that changes from row to
    row is read from the device, so a CUDA graph of one call serves every
    row of its stage, and on a kf mesh one graph of each half
    (``slam/programs.py``)."""
    reduce = None if kf is None else kf.reduce
    if reduce is None:
        loss, grads = mapping_grads(pp, tab, inp, intr, pcfg, rcfg, stage, kf)
    else:
        loss, grads, used = mapping_grads(pp, tab, inp, intr, pcfg, rcfg, stage, kf, flat)
        reduce(flat[:used])
    mapping_step(pp, opt_state, tab, inp, loss, grads, zero)


def run_schedule(
    pp: PassParams,
    opt_state: AdamState,
    sched: Schedule,
    grid_masks: Optional[Dict[str, torch.Tensor]],
    bounds,
    scene_bound,
    intr: Intrinsics,
    colors,
    depths,
    frame_valid: np.ndarray,
    cam_fixed: np.ndarray,
    pcfg: ProgConfig,
    rcfg: RenderConfig,
    gen: Optional[torch.Generator] = None,
    pixels=None,
    kf: Optional[KfSlice] = None,
) -> torch.Tensor:
    """Run one schedule chunk in place on ``pp`` and ``opt_state``; returns
    the per-row losses (0 on inactive rows), still on the device. Each
    active row is one :func:`mapping_iteration` on tables made for the
    chunk.

    ``pixels`` maps a row's ``iter_idx`` to injected ``(fidx, i, j)`` draws;
    by default each active row draws from ``gen``, all rows up front in row
    order (nothing else draws from ``gen`` during a pass, so these are the
    draws that row by row would give). The sharded mapping program
    (``parallel/sharded_mapper.py``) passes its rank's :class:`KfSlice`:
    each row still draws all ``n_pixels`` rays and evaluates the rank's
    slice, and the loss and gradients are summed over the kf group in one
    flat buffer before the Adam step.
    """
    dev = colors.device
    rows = np.flatnonzero(sched.active)
    inp = PassInputs(
        bounds, scene_bound, colors, depths, to_device(frame_valid, dev),
        to_device(cam_fixed, dev), grid_masks if pcfg.frustum else None,
    )
    if pixels is None:
        valid_idx = to_device(np.flatnonzero(frame_valid), dev)
        draws = [draw_mapping_pixels(gen, valid_idx, pcfg.n_pixels, intr, dev) for _ in rows]
    else:
        draws = [pixels[int(sched.iter_idx[r])] for r in rows]
    lrs = schedule_lrs(sched)[rows]
    tab = new_pass_tables(len(rows), pcfg.n_pixels, dev, count0=opt_state.count)
    flat = None if kf is None or kf.reduce is None else new_flat(pp.leaves)
    if len(rows):
        start_pass(tab, lrs, stack_draws(draws, dev))
    for k, r in enumerate(rows):
        mapping_iteration(
            pp, opt_state, tab, inp, intr, pcfg, rcfg,
            STAGE_ORDER[int(sched.stage_ids[r])], lr_zero(lrs[k]), kf=kf, flat=flat,
        )
    opt_state.count += len(rows)
    pos = np.cumsum(sched.active) - 1
    return torch.stack([
        tab.losses[pos[r]] if sched.active[r] else torch.zeros((), device=dev)
        for r in range(len(sched))
    ])


def optimize_window(
    grids,
    decoders,
    cam_tensors,  # [F, 7]
    grid_masks,
    bounds,
    scene_bound,
    intr: Intrinsics,
    colors,
    depths,
    frame_valid: np.ndarray,
    cam_fixed: np.ndarray,
    gen: Optional[torch.Generator],
    plan: StagePlan,
    cfg: MapOptConfig,
    rcfg: RenderConfig,
    n_pixels: int,
    pixels=None,
):
    """The whole staged mapping optimization of one window in one call.

    Returns ``(grids, decoders, cam_tensors, losses)`` (detached; the inputs
    are not modified), ``losses`` the loss of every iteration across the
    stages. The rays come from ``gen``, or from ``pixels`` as in
    :func:`run_schedule`. ``NiceSLAM`` (``slam/system.py``) calls
    :func:`run_schedule` itself, in chunks; this expands the plan at once.
    """
    sched = schedule_arrays(plan, cfg)
    pcfg = ProgConfig(
        n_pixels=n_pixels,
        w_color_loss=cfg.w_color_loss,
        frustum=cfg.frustum_feature_selection,
        ba=cfg.BA,
        dec_train=dec_train_from_plan(plan, cfg),
        tv_weight=cfg.tv_weight,
        fs_weight=cfg.fs_weight,
        fs_band=cfg.fs_band,
    )
    pp = make_pass_params(grids, decoders, cam_tensors, pcfg)
    losses = run_schedule(
        pp, init_opt_state(pp), sched, grid_masks, bounds, scene_bound, intr,
        colors, depths, frame_valid, cam_fixed, pcfg, rcfg, gen=gen, pixels=pixels,
    )
    out = tree_map(lambda t: t.detach(), pp.params)
    return out["grids"], out["decoders"], out["cams"], losses


optimize_map = optimize_window
