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
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.schema import StageLR
from ..core.pose import camera_from_tensor, to_homogeneous
from ..core.rays import Intrinsics, pixel_dirs
from ..models.decoders import tree_leaves
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
    frame_valid: np.ndarray,
    n: int,
    intr: Intrinsics,
    device,
):
    """``(fidx, i, j)``: each ray's window frame uniformly over the valid
    slots, and a uniform pixel."""
    valid_idx = torch.as_tensor(np.flatnonzero(frame_valid), device=device)
    k = torch.randint(0, len(valid_idx), (n,), generator=gen, device=device)
    j = torch.randint(0, intr.H, (n,), generator=gen, device=device)
    i = torch.randint(0, intr.W, (n,), generator=gen, device=device)
    return valid_idx[k], i, j


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
):
    """One joint-iteration loss over the keyframe window: per-ray depth L1
    over gt > 0 pixels, the free-space occupancy term, the color L1 in the
    color stage, and the optional TV term. Rays originate from the current
    camera tensors, so BA gradients reach the poses through the sampler's
    coordinate gradients."""
    grids, decoders, cams = (
        all_params["grids"], all_params["decoders"], all_params["cams"]
    )
    cams = torch.where(cam_fixed[:, None], cams.detach(), cams)
    c2ws = to_homogeneous(camera_from_tensor(cams))  # [F, 4, 4]
    dirs = pixel_dirs(intr, i.to(torch.float32), j.to(torch.float32))
    rays_o = c2ws[fidx, :3, 3]
    rays_d = torch.einsum("nij,nj->ni", c2ws[fidx, :3, :3], dirs)
    gt_depth = depths[fidx, j, i]
    gt_color = colors[fidx, j, i]
    ray_w = frame_valid[fidx].to(torch.float32)

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
    """``optax.scale_by_adam`` state over a pass's trainable leaves."""

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


@torch.no_grad()
def adam_update(
    pp: PassParams,
    grads: List[Optional[torch.Tensor]],
    state: AdamState,
    lr_grids: np.ndarray,
    lr_dec: np.ndarray,
    lr_cam: float,
    grid_masks: Optional[Dict[str, torch.Tensor]],
) -> None:
    """One ``scale_by_adam`` step on unmasked grads, then
    ``p -= lr * update * mask`` per group, in place."""
    state.count += 1
    # Bias corrections in float32, as optax computes them (1 - b2 in float32
    # differs from the float64 value by ~1e-5 relative at count 1).
    k = np.float32(state.count)
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** k)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** k)
    for p, g, mu, nu, (kind, lvl) in zip(
        pp.leaves, grads, state.mu, state.nu, pp.groups
    ):
        if g is None:  # a leaf this stage does not touch: zero gradient
            mu.mul_(ADAM_B1)
            nu.mul_(ADAM_B2)
        else:
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        if kind == "grids":
            lr = float(lr_grids[LEVEL_ORDER.index(lvl)])
        elif kind == "decoders":
            lr = float(lr_dec[LEVEL_ORDER.index(lvl)])
        else:
            lr = float(lr_cam)
        if lr == 0.0:
            continue
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if kind == "grids" and grid_masks is not None:
            upd = upd * grid_masks[lvl]
        p.sub_(lr * upd)


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
) -> torch.Tensor:
    """Run one schedule chunk in place on ``pp`` and ``opt_state``; returns
    the per-row losses (0 on inactive rows), still on the device.

    ``pixels`` maps a row's ``iter_idx`` to injected ``(fidx, i, j)`` draws;
    by default each active row draws from ``gen``.
    """
    dev = colors.device
    valid_t = torch.as_tensor(frame_valid, device=dev)
    fixed_t = torch.as_tensor(cam_fixed, device=dev)
    masks = grid_masks if pcfg.frustum else None
    losses = []
    for r in range(len(sched)):
        if not sched.active[r]:
            losses.append(torch.zeros((), device=dev))
            continue
        stage = STAGE_ORDER[int(sched.stage_ids[r])]
        if pixels is not None:
            fidx, i, j = pixels[int(sched.iter_idx[r])]
        else:
            fidx, i, j = draw_mapping_pixels(gen, frame_valid, pcfg.n_pixels, intr, dev)
        loss = mapping_loss(
            pp.params, bounds, scene_bound, intr, colors, depths, valid_t,
            fixed_t, fidx, i, j, stage, pcfg.w_color_loss, rcfg,
            tv_weight=pcfg.tv_weight, fs_weight=pcfg.fs_weight, fs_band=pcfg.fs_band,
        )
        grads = torch.autograd.grad(loss, pp.leaves, allow_unused=True)
        adam_update(
            pp, list(grads), opt_state, sched.lr_grids[r], sched.lr_dec[r],
            float(sched.lr_cam[r]), masks,
        )
        losses.append(loss.detach())
    return torch.stack(losses)
