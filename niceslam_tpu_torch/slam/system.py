"""NiceSLAM system driver: the per-frame track/map loop (strict sync, one device).

    frame 0:     mapper initialization (iters_first, lr_first_factor)
    every frame: track (Gauss-Newton, warm-started by the constant-speed model)
    bootstrap frames, every `every_frame`-th frame and the last frame:
                 coarse mapper pass, then the staged pass; optional re-track
                 of the event frame on the fresh map; keyframe admission
    last frame:  optional color-refinement passes

Strict sync: the tracker always reads the mapper's latest published map, and
each mapping pass is checked (finite final loss) before it is published; a
diverged pass is rejected and the map stays as it was (the NaN guard). A
pass optimizes clones of the published tensors, so rejecting it is free.

Randomness: grid/decoder init draws from a CPU ``torch.Generator`` seeded
with ``seed``; tracker, mapper and overlap pixel draws from a generator on
the run's device. Keyframe-window selection uses
``np.random.default_rng((seed, frame, salt))`` exactly as the JAX package
does, so the two pick the same windows from the same candidates.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..config.schema import SLAMConfig
from ..core.pose import (
    camera_from_tensor,
    constant_speed_warm_start,
    tensor_from_camera,
    to_homogeneous,
)
from ..core.rays import Intrinsics, draw_pixels
from ..eval.ate import ate_rmse
from ..grid.hierarchy import GridConfig, init_grids
from ..io.datasets.base import Frame, FrameReader
from ..models.decoders import DecoderConfig, init_decoders
from ..models.pretrained import load_decoders_npz
from ..render.renderer import RenderConfig
from . import keyframes as kf_mod
from .mapper import (
    MapOptConfig,
    ProgConfig,
    build_stage_plan,
    chunked_schedule,
    dec_train_table,
    init_opt_state,
    make_pass_params,
    run_schedule,
)
from .state import MapState, add_keyframe, init_keyframe_db
from .tracker import TrackConfig, track_frame


class NiceSLAM:
    """Single-device SLAM engine over an RGB-D frame stream."""

    def __init__(
        self,
        cfg: SLAMConfig,
        reader: Optional[FrameReader] = None,
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "NiceSLAM runs on cuda by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if cfg.sync_method != "strict":
            raise NotImplementedError("only sync_method='strict' is implemented")
        if cfg.tracking.method != "gn":
            raise NotImplementedError("only the Gauss-Newton tracker is implemented")
        if reader is None:
            if cfg.dataset != "synthetic":
                raise NotImplementedError(f"no reader for dataset {cfg.dataset!r}")
            from ..io.datasets.synthetic import SyntheticBoxReader

            reader = SyntheticBoxReader(cfg)
        self.cfg = cfg
        self.seed = seed
        self.reader = reader
        c = cfg.cam
        self.intr = Intrinsics(
            H=c.H - 2 * c.crop_edge,
            W=c.W - 2 * c.crop_edge,
            fx=c.fx,
            fy=c.fy,
            cx=c.cx - c.crop_edge,
            cy=c.cy - c.crop_edge,
        )
        init_gen = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        gl = cfg.grid_len
        grid_cfg = GridConfig(
            coarse_len=gl.coarse,
            middle_len=gl.middle,
            fine_len=gl.fine,
            color_len=gl.color,
            bound_divisable=gl.bound_divisable,
            c_dim=cfg.model.c_dim,
            coarse_bound_enlarge=cfg.model.coarse_bound_enlarge,
        )
        grids, self.bounds, bound = init_grids(
            np.asarray(cfg.bound, np.float32) * cfg.scale, grid_cfg,
            gen=init_gen, device=self.device,
        )
        self.scene_bound = torch.as_tensor(bound, device=self.device)
        dec_cfg = DecoderConfig(
            c_dim=cfg.model.c_dim, hidden=cfg.model.hidden_size, coarse=cfg.coarse
        )
        decoders = init_decoders(dec_cfg, gen=init_gen, device=self.device)
        if cfg.pretrained_coarse or cfg.pretrained_middle_fine:
            if not cfg.pretrained_middle_fine.endswith(".npz"):
                raise NotImplementedError(
                    "only the .npz pretrained-decoder format is implemented"
                )
            decoders = load_decoders_npz(cfg.pretrained_middle_fine, decoders)
        self.state = MapState(
            grids=grids,
            decoders=decoders,
            keyframes=init_keyframe_db(
                cfg.mapping.max_keyframes, self.intr.H, self.intr.W, self.device
            ),
        )
        # Pretrained decoders stay frozen (fix_fine semantics); otherwise
        # mapping.decoder_train decides ('never' / 'init' / 'always').
        self.decoder_train = (
            "never" if cfg.pretrained_middle_fine else cfg.mapping.decoder_train
        )
        self.rcfg = RenderConfig(
            n_samples=cfg.rendering.N_samples,
            n_surface=cfg.rendering.N_surface,
            n_importance=cfg.rendering.N_importance,
            perturb=cfg.rendering.perturb,
            lindisp=cfg.rendering.lindisp,
            occupancy=cfg.occupancy,
            surface_band=cfg.rendering.surface_band,
        )
        t = cfg.tracking
        self.tcfg = TrackConfig(
            pixels=t.pixels,
            iters=t.iters,
            use_color=t.use_color_in_tracking,
            w_color_loss=t.w_color_loss,
            handle_dynamic=t.handle_dynamic,
            depth_err_gate=t.depth_err_gate,
            gn_prior_sigma_r=t.gn_prior_sigma_r,
            gn_prior_sigma_t=t.gn_prior_sigma_t,
            gn_step_clip=t.gn_step_clip,
            gn_depth_offset_sigma=t.gn_depth_offset_sigma,
            ignore_edge_H=t.ignore_edge_H,
            ignore_edge_W=t.ignore_edge_W,
        )
        # Observed-voxel locking (mapping.lock_after): per-level event counts
        # [Z, Y, X, 1]; a voxel counted >= lock_after times gets no updates.
        self._obs_counts = (
            {
                lvl: torch.zeros(g.shape[:3] + (1,), device=self.device)
                for lvl, g in grids.items()
            }
            if cfg.mapping.lock_after > 0
            else None
        )
        self._event_frustum = None
        self.est_c2w: List[np.ndarray] = []
        self.gt_c2w: List[Optional[np.ndarray]] = []
        self.track_losses: List[float] = []
        self.events: List[dict] = []
        self.n_imgs = len(self.reader)
        # Host mirrors of the keyframe-DB bookkeeping.
        self._kf_count = 0
        self._kf_slot_frame = np.full((cfg.mapping.max_keyframes,), -1, np.int64)
        # Overlap percentages for the next event's keyframe selection.
        self._overlap_pct = None

    # ------------------------------------------------------------------ util
    def _log(self, record: dict):
        self.events.append(record)
        if self.cfg.verbose:
            print(f"[niceslam_torch] {record}")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -------------------------------------------------------------- tracking
    def track(self, frame: Frame) -> np.ndarray:
        cfgt = self.cfg.tracking
        idx = len(self.est_c2w)
        if idx == 0 or cfgt.gt_camera:
            gt = frame.gt_c2w if frame.gt_c2w is not None else np.eye(4)
            c2w = np.asarray(gt, np.float32)
        else:
            prev = self._tensor(self.est_c2w[-1])
            if cfgt.const_speed_assumption and idx >= 2:
                init = constant_speed_warm_start(prev, self._tensor(self.est_c2w[-2]))
            else:
                init = prev
            st = self.state
            c2w_t, loss_curve = track_frame(
                st.decoders, st.grids, self.bounds, self.scene_bound, self.intr,
                frame.color, frame.depth, init, self.tcfg, self.rcfg, gen=self.gen,
            )
            c2w = c2w_t.cpu().numpy().astype(np.float32)
            self.track_losses.append(float(loss_curve[-1]))
        self.est_c2w.append(c2w)
        self.gt_c2w.append(
            None if frame.gt_c2w is None else np.asarray(frame.gt_c2w, np.float32)
        )
        return c2w

    # --------------------------------------------------------------- mapping
    def _window_slots(self, idx: int, coarse: bool, salt: int = 0):
        """Keyframe slots for the optimization window: (window-2) selected
        keyframes + the most recent keyframe (the current frame comes after
        them)."""
        cap = self.state.keyframes.capacity
        count = self._kf_count
        wsize = self.cfg.mapping.mapping_window_size
        n_sel = wsize - 2
        slots: List[int] = []
        if count > 0:
            last = (count - 1) % cap
            prev_slots = [s % cap for s in range(max(0, count - cap), count - 1)]
            if prev_slots and n_sel > 0:
                method = "global" if coarse else self.cfg.mapping.keyframe_selection_method
                rng = np.random.default_rng((self.seed, idx, salt))
                if method == "global":
                    slots = [int(s) for s in rng.permutation(prev_slots)[:n_sel]]
                else:
                    # Overlap selection reads the percentages computed at the
                    # end of the previous event; the first overlap event
                    # (none computed yet) selects globally.
                    if self._overlap_pct is not None:
                        p = self._overlap_pct.cpu().numpy()
                        cand = [s for s in prev_slots if p[s] > 0]
                    else:
                        cand = prev_slots
                    slots = [int(s) for s in rng.permutation(cand)[:n_sel]]
            slots = slots + [last]
        return slots, wsize

    def map_frame(self, frame: Frame, first: bool = False):
        """One mapping event: optional coarse pass + staged mapping."""
        m = self.cfg.mapping
        idx = len(self.est_c2w) - 1
        cur_c2w = self.est_c2w[-1]
        is_last = idx == self.n_imgs - 1
        outer = 1
        if first:
            mode, iters, lr_factor = "init", m.iters_first, m.lr_first_factor
        elif is_last and m.color_refine:
            mode, iters, lr_factor = "refine", m.iters, m.lr_factor
            outer = 5
        else:
            mode, iters, lr_factor = "normal", m.iters, m.lr_factor
            if idx < m.bootstrap_frames and m.bootstrap_iters > 0:
                iters = m.bootstrap_iters
        self._train_decoders_now = self.decoder_train == "always" or (
            self.decoder_train == "init" and first
        )
        if self.cfg.coarse and not first:
            self._run_mapper(frame, cur_c2w, m.iters, lr_factor, coarse=True, refine=False)
        for outer_i in range(outer):
            cur_c2w = self._run_mapper(
                frame, cur_c2w, iters, lr_factor, coarse=False,
                refine=(mode == "refine"), sel_salt=outer_i,
            )
        self.est_c2w[-1] = np.asarray(cur_c2w, np.float32)

        if self._obs_counts is not None and self._event_frustum is not None:
            for lvl in self._obs_counts:
                self._obs_counts[lvl] = self._obs_counts[lvl] + self._event_frustum[lvl]
            self._event_frustum = None

        if m.retrack and not first and not self.cfg.tracking.gt_camera:
            self._retrack_event_frame(frame)

        if (
            idx % m.keyframe_every == 0
            or idx < m.bootstrap_frames
            or idx == self.n_imgs - 2
        ) and not self._is_keyframe(idx):
            gt = self.gt_c2w[-1]
            add_keyframe(
                self.state.keyframes, frame.color, frame.depth,
                self._tensor(self.est_c2w[-1]),
                self._tensor(gt if gt is not None else np.eye(4)), idx,
            )
            slot = self._kf_count % self.state.keyframes.capacity
            self._kf_slot_frame[slot] = idx
            self._kf_count += 1
        self.state.version += 1
        if m.keyframe_selection_method == "overlap" and self._kf_count > 1:
            i, j = draw_pixels(self.gen, self.intr, 100, device=self.device)
            self._overlap_pct = kf_mod.keyframe_overlap_percentages(
                self.intr, self._tensor(self.est_c2w[-1]), frame.depth,
                frame.color, self.state.keyframes.est_c2w, i, j,
            )

    def _retrack_event_frame(self, frame: Frame):
        """One extra pose solve for the event frame against the fresh map."""
        st = self.state
        c2w_t, _ = track_frame(
            st.decoders, st.grids, self.bounds, self.scene_bound, self.intr,
            frame.color, frame.depth, self._tensor(self.est_c2w[-1]),
            self.tcfg, self.rcfg, gen=self.gen,
        )
        self.est_c2w[-1] = c2w_t.cpu().numpy().astype(np.float32)

    def _is_keyframe(self, idx: int) -> bool:
        return bool(np.any(self._kf_slot_frame == idx))

    def _make_mcfg(self, ba: bool, refine: bool, lr_factor) -> MapOptConfig:
        m = self.cfg.mapping
        return MapOptConfig(
            pixels=m.pixels,
            w_color_loss=m.w_color_loss,
            BA=ba,
            BA_cam_lr=m.BA_cam_lr,
            fix_fine=m.fix_fine,
            fix_color=m.fix_color or refine,
            frustum_feature_selection=m.frustum_feature_selection and not refine,
            lr_factor=float(lr_factor),
            train_all_decoders=getattr(self, "_train_decoders_now", False)
            and not refine,
            decoders_lr_fallback=m.decoders_lr,
        )

    def _make_pcfg(self, mcfg: MapOptConfig) -> ProgConfig:
        m = self.cfg.mapping
        return ProgConfig(
            n_pixels=m.pixels,
            w_color_loss=mcfg.w_color_loss,
            frustum=mcfg.frustum_feature_selection,
            ba=mcfg.BA,
            dec_train=dec_train_table(m.stage_lr, mcfg),
            tv_weight=m.tv_weight,
            fs_weight=m.fs_weight,
            fs_band=m.fs_band,
        )

    def _run_mapper(
        self, frame: Frame, cur_c2w, iters, lr_factor, coarse: bool,
        refine: bool, sel_salt: int = 0,
    ):
        m = self.cfg.mapping
        db = self.state.keyframes
        idx = len(self.est_c2w) - 1
        slots, wsize = self._window_slots(idx, coarse, salt=sel_salt)
        if refine:
            wsize *= 2
            count = self._kf_count
            for s in (s % db.capacity for s in range(max(0, count - db.capacity), count)):
                if s not in slots and len(slots) < wsize - 1:
                    slots.append(s)
        # Fixed window shape: every pass uses the full window, with unused
        # slots invalid; the current frame sits right after the keyframes.
        F = wsize
        wcur = len(slots)
        sel = torch.zeros((F,), dtype=torch.long, device=self.device)
        sel[:wcur] = torch.as_tensor(slots, dtype=torch.long)
        colors = db.colors[sel]
        depths = db.depths[sel]
        poses44 = db.est_c2w[sel]
        colors[wcur] = frame.color
        depths[wcur] = frame.depth
        poses44[wcur] = self._tensor(cur_c2w)
        cams = tensor_from_camera(poses44)

        valid = np.zeros((F,), bool)
        valid[: wcur + 1] = True
        fixed = np.ones((F,), bool)
        oldest = None
        for w, s in enumerate(slots):
            if oldest is None or self._kf_slot_frame[s] < self._kf_slot_frame[slots[oldest]]:
                oldest = w
        # BA once more than BA_min_keyframes keyframes exist, never in the
        # coarse pass; the oldest window keyframe stays pinned.
        ba = m.BA and self._kf_count > m.BA_min_keyframes and not coarse
        if ba:
            fixed[:] = ~valid
            if oldest is not None:
                fixed[oldest] = True

        mcfg = self._make_mcfg(ba, refine, lr_factor)
        plan = build_stage_plan(
            iters,
            0.0 if refine else m.middle_iter_ratio,
            0.0 if refine else m.fine_iter_ratio,
            m.stage_lr,
            coarse=coarse,
        )
        grids = self.state.grids
        if mcfg.frustum_feature_selection:
            masks = kf_mod.frustum_masks_for_levels(
                poses44, torch.as_tensor(valid, device=self.device), depths,
                self.intr, self.bounds, grids,
            )
        else:
            masks = {lvl: torch.ones(g.shape[:3] + (1,), device=self.device)
                     for lvl, g in grids.items()}
        if self._obs_counts is not None:
            if not coarse:
                self._event_frustum = masks
            lock = float(m.lock_after)
            masks = {
                lvl: mk * (self._obs_counts[lvl] < lock).to(mk.dtype)
                for lvl, mk in masks.items()
            }

        pcfg = self._make_pcfg(mcfg)
        n_total = sum(n for _, n, _ in plan)
        chunks, reals = chunked_schedule(plan, mcfg, min(m.iters, n_total))
        pp = make_pass_params(grids, self.state.decoders, cams, pcfg)
        opt_state = init_opt_state(pp)
        parts = []
        for chunk, real in zip(chunks, reals):
            lo = run_schedule(
                pp, opt_state, chunk, masks, self.bounds, self.scene_bound,
                self.intr, colors, depths, valid, fixed, pcfg, self.rcfg,
                gen=self.gen,
            )
            parts.append(lo[:real])
        losses_np = torch.cat(parts).cpu().numpy()
        # NaN guard: a diverged pass is never published.
        if not np.isfinite(losses_np[-1]):
            self._log({
                "event": "map_rejected", "frame": idx, "coarse": coarse,
                "loss_last": float(losses_np[-1]),
            })
            return np.asarray(cur_c2w)
        params = pp.params
        self.state.grids = {k: v.detach() for k, v in params["grids"].items()}
        self.state.decoders = _detach_tree(params["decoders"])
        self._log({
            "event": "map", "frame": idx, "coarse": coarse,
            "stages": [p[0] for p in plan],
            "loss_first": float(losses_np[0]), "loss_last": float(losses_np[-1]),
        })
        if ba:
            # Write the optimized keyframe poses back.
            new_poses = to_homogeneous(camera_from_tensor(params["cams"].detach()))
            for w, s in enumerate(slots):
                if not fixed[w]:
                    db.est_c2w[s] = new_poses[w]
            if not fixed[wcur]:
                return new_poses[wcur].cpu().numpy()
        return np.asarray(cur_c2w)

    # ------------------------------------------------------------------ run
    def step(self, frame: Frame):
        """Process one frame: track, then map if scheduled."""
        idx = len(self.est_c2w)
        t0 = time.perf_counter()
        first = idx == 0
        # One host-to-device copy per frame, shared by track and map.
        frame = Frame(
            idx=frame.idx,
            color=self._tensor(frame.color),
            depth=self._tensor(frame.depth),
            gt_c2w=frame.gt_c2w,
        )
        self.track(frame)
        t_track = time.perf_counter()
        m = self.cfg.mapping
        if (
            first
            or idx < m.bootstrap_frames
            or idx % m.every_frame == 0
            or idx == self.n_imgs - 1
        ):
            self.map_frame(frame, first=first)
        t_end = time.perf_counter()
        # Host clocks; strict mode reads the pose and the mapping losses
        # back before each section ends, so they cover the device work too.
        self._log({
            "event": "frame", "frame": idx,
            "dt": round(t_end - t0, 4),
            "dt_track": round(t_track - t0, 4),
            "dt_map": round(t_end - t_track, 4),
            "track_loss": self.track_losses[-1] if idx > 0 and self.track_losses else None,
        })

    def run(self, n_frames: Optional[int] = None):
        n = len(self.reader) if n_frames is None else min(n_frames, len(self.reader))
        self.n_imgs = n
        for k in range(n):
            self.step(self.reader[k])
        return self.result()

    def result(self):
        out = {"est_c2w": self.est_c2w, "gt_c2w": self.gt_c2w}
        gts = [g for g in self.gt_c2w if g is not None]
        if len(gts) == len(self.est_c2w) and len(gts) > 1:
            out["ate_rmse"] = ate_rmse(self.est_c2w, gts)
        return out


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach_tree(v) for v in tree)
    return tree.detach()
