"""NiceSLAM: the per-frame track/map loop.

    frame 0:     mapper initialization (iters_first, lr_first_factor)
    every frame: track (Gauss-Newton or Adam, warm-started by the
                 constant-speed model)
    bootstrap frames, every `every_frame`-th frame and the last frame:
                 coarse mapper pass, then the staged pass; optional re-track
                 of the event frame on the fresh map; keyframe admission
    last frame:  optional color-refinement passes

Sync methods (``cfg.sync_method``), which change when the host waits for
the card, never the math:

- ``"strict"``: the host reads each tracked pose and each mapping pass's
  losses back at once. A pass is checked (finite final loss) before it is
  published; a diverged pass is rejected and the map stays as it was (the
  NaN guard). A pass optimizes clones of the published tensors, so
  rejecting it is free.
- ``"async"``: the upstream concurrent tracker/mapper semantics. Poses stay
  tensors on the device and every pass is published at once; each event's
  loss tails are copied to the host without waiting
  (:class:`~..core.transfer.HostCopy`) and checked at the next event or at
  :meth:`NiceSLAM.flush`. If any pass of an event diverged, the WHOLE event
  rolls back: grids, decoders, the keyframe DB and its host mirrors, the
  observed-voxel counts, the event frame's pose, and any later non-finite
  pose (held at the last finite one). The track-loss curves are read at
  ``flush``.

Devices (``devices``, the counterpart of the JAX package's visible
devices): the first is the main device, where the map lives. With two or
more, ``parallel.track_role`` runs the tracker on the last one against a
copy of the map taken once per published version, and ``parallel.stage_ep``
runs the coarse pass on the second one, from the state before the event,
and merges the coarse level back after the staged pass (the coarse pass
touches no level the staged pass reads); in strict sync its NaN guard is
settled at the merge. Both draw their pixels from the main device's
generator, so they compute what the plain run computes, bit for bit. A
multi-rank runtime attached with ``MapKfRuntime.attach``
(``parallel/runtime.py``) runs every mapping pass sharded over its
('map', 'kf') mesh and turns both roles off, as in the JAX package.

Programs (``slam/programs.py``): every pose solve, every mapping pass, the
keyframe overlap and the frustum masks run as programs over static
buffers; on a card (``capture``, on by default there) each iteration or
call is a replay of a captured CUDA graph, the counterpart of the JAX
package's jitted programs, and :meth:`NiceSLAM.precompile` captures every
signature before frame 0. Under a multi-rank runtime a pass's iteration
is a few graphs around eager collectives, which no graph holds: two around
the kf all_reduce with one map block, and with ``map > 1`` the segments of
``parallel/sharded_mapper.MapSegments`` around 3 collectives (4 with
``kf > 1``) on this rank's Z blocks.

Randomness: grid/decoder init draws from a CPU ``torch.Generator`` seeded
with ``seed``; tracker, mapper and overlap pixel draws from a generator on
the main device. Keyframe-window selection uses
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
from ..core.transfer import HostCopy, to_device
from ..eval.ate import ate_rmse
from ..grid.hierarchy import GridConfig
from ..io.datasets.base import Frame, FrameReader, get_dataset
from ..io.prefetch import Prefetcher
from ..models.decoders import DecoderConfig
from ..models.pretrained import load_pretrained_decoders
from ..render.renderer import RenderConfig
from ..utils.checkpoint import load_checkpoint
from ..utils.logging import MetricsLogger
from ..utils.profiling import StepTimer, annotate
from ..utils.visualizer import save_frame_vis
from . import keyframes as kf_mod
from .mapper import (
    MapOptConfig,
    ProgConfig,
    build_stage_plan,
    dec_train_table,
    draw_mapping_pixels,
    schedule_arrays,
    stack_draws,
)
from .programs import Programs, resolve_capture
from .state import (
    add_keyframe,
    init_state,
    restore_keyframes,
    snapshot_keyframes,
)
from .tracker import draw_track_pixels, track_config


class NiceSLAM:
    """SLAM engine over an RGB-D frame stream.

    ``devices`` lists the devices of the roles, the main device first; when
    given it takes the place of ``device``. By default it is ``device``
    followed by the other visible cards (none on the CPU).

    ``capture`` runs the programs as CUDA graphs: ``None`` (the default)
    on CUDA devices and not on the CPU; ``False`` on a card runs them
    eagerly, to compare the two; ``True`` on the CPU raises."""

    def __init__(
        self,
        cfg: SLAMConfig,
        reader: Optional[FrameReader] = None,
        seed: int = 0,
        device=DEFAULT_DEVICE,
        log_path: Optional[str] = None,
        devices=None,
        capture: Optional[bool] = None,
    ):
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
            self.device = self.devices[0]
        else:
            self.device = torch.device(device)
            self.devices = [self.device]
        if any(d.type == "cuda" for d in self.devices) and not torch.cuda.is_available():
            raise RuntimeError(
                "NiceSLAM runs on cuda by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if devices is None and self.device.type == "cuda":
            main = self.device.index if self.device.index is not None else torch.cuda.current_device()
            self.devices += [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count()) if i != main]
        self._programs = Programs(resolve_capture(capture, self.devices))
        if cfg.sync_method not in ("strict", "async"):
            raise ValueError(f"unknown sync_method {cfg.sync_method!r}")
        if cfg.tracking.method not in ("gn", "adam"):
            raise ValueError(f"unknown tracking.method {cfg.tracking.method!r}")
        if reader is None:
            reader = get_dataset(cfg)
        self.cfg = cfg
        self.seed = seed
        self.reader = reader
        self.sync_method = cfg.sync_method
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
        dec_cfg = DecoderConfig(
            c_dim=cfg.model.c_dim, hidden=cfg.model.hidden_size, coarse=cfg.coarse
        )
        self.state, bounds, bound = init_state(
            np.asarray(cfg.bound, np.float32) * cfg.scale, self.intr.H, self.intr.W,
            grid_cfg, dec_cfg, cfg.mapping.max_keyframes, gen=init_gen, device=self.device,
        )
        self._set_bounds(bounds, torch.as_tensor(bound, device=self.device))
        if cfg.pretrained_coarse or cfg.pretrained_middle_fine:
            self.state.decoders = load_pretrained_decoders(
                self.state.decoders, cfg.pretrained_coarse, cfg.pretrained_middle_fine
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
        self.tcfg = track_config(cfg.tracking)
        # Observed-voxel locking (mapping.lock_after): per-level event counts
        # [Z, Y, X, 1]; a voxel counted >= lock_after times gets no updates.
        self._obs_counts = (
            {
                lvl: torch.zeros(g.shape[:3] + (1,), device=self.device)
                for lvl, g in self.state.grids.items()
            }
            if cfg.mapping.lock_after > 0
            else None
        )
        self._event_frustum = None
        # Poses: numpy [4, 4] in strict sync, device tensors in async sync
        # until flush() reads them back.
        self.est_c2w: List = []
        self.gt_c2w: List[Optional[np.ndarray]] = []
        self.track_losses: List[float] = []
        self.log = MetricsLogger(log_path, verbose=cfg.verbose)
        self.timer = StepTimer()
        self.n_imgs = len(self.reader)
        # Test-only fault injection: called with (frame index, (grids,
        # decoders, cams, losses)) of every mapping pass, it may corrupt
        # them; the NaN guard must contain the fault.
        self.fault_hook = None
        # A directory for render panels (utils/visualizer.py) every
        # mapping.vis_freq frames; None writes none.
        self.vis_dir: Optional[str] = None
        # Async sync: the last event's (snapshot, passes, loss tails) until
        # _verify_pending checks it, and the deferred track-loss curves.
        self._pending_verify = None
        self._track_loss_dev: List[torch.Tensor] = []
        # Host mirrors of the keyframe-DB bookkeeping.
        self._kf_count = 0
        self._kf_slot_frame = np.full((cfg.mapping.max_keyframes,), -1, np.int64)
        # Overlap percentages for the next event's keyframe selection
        # (a HostCopy started at the end of the previous event).
        self._overlap_pct = None
        # The attached multi-rank runtime (parallel/runtime.py), or None.
        self._runtime = None
        # track_role: (state.version, the map on the tracker's device).
        self._track_snap = None
        # stage_ep: the coarse expert's pass until map_frame merges it.
        self._ep_pending = None

    # ------------------------------------------------------------------ util
    @property
    def events(self) -> List[dict]:
        """Every record logged so far (``self.log.records``)."""
        return self.log.records

    def _tensor(self, x) -> torch.Tensor:
        return to_device(x, self.device, torch.float32)

    def _set_bounds(self, bounds, scene_bound):
        self.bounds = bounds
        self.scene_bound = scene_bound
        # Host copies for the frustum masks, read once here.
        self._bounds_host = {k: v.cpu().numpy() for k, v in bounds.items()}

    def _fit_obs_counts(self):
        """Give the observed-voxel counts the grids' Z again after padding or
        a restore changed it (rows past the old Z count from zero)."""
        if self._obs_counts is None:
            return
        for lvl, g in self.state.grids.items():
            c = self._obs_counts[lvl]
            if c.shape[0] != g.shape[0]:
                new = torch.zeros(g.shape[:3] + (1,), device=self.device)
                z = min(c.shape[0], g.shape[0])
                new[:z] = c[:z]
                self._obs_counts[lvl] = new

    def _track_device(self):
        """The tracker role's device (``parallel.track_role``), or None to
        track on the main device: the last device when there are two or
        more and no runtime is attached."""
        if self.cfg.parallel.track_role and self._runtime is None and len(self.devices) > 1:
            return self.devices[-1]
        return None

    def _expert_device(self):
        """The coarse stage expert's device (``parallel.stage_ep``), or
        None: the second device, when no runtime is attached."""
        if self.cfg.parallel.stage_ep and self._runtime is None and len(self.devices) > 1:
            return self.devices[1]
        return None

    def _track_snapshot(self, device):
        """The published map on the tracker's device, copied once per
        published version."""
        v = self.state.version
        if self._track_snap is None or self._track_snap[0] != v:
            st = self.state
            self._track_snap = (v, (
                _tree_to(st.decoders, device), _tree_to(st.grids, device),
                _tree_to(self.bounds, device), self.scene_bound.to(device),
            ))
        return self._track_snap[1]

    # -------------------------------------------------------------- tracking
    def track(self, frame: Frame):
        cfgt = self.cfg.tracking
        idx = len(self.est_c2w)
        if idx == 0 or cfgt.gt_camera:
            gt = frame.gt_c2w if frame.gt_c2w is not None else np.eye(4)
            c2w = np.asarray(gt, np.float32)
            if self.sync_method == "async":
                c2w = self._tensor(c2w)
        else:
            prev = self._tensor(self.est_c2w[-1])
            if cfgt.const_speed_assumption and idx >= 2:
                init = constant_speed_warm_start(prev, self._tensor(self.est_c2w[-2]))
            else:
                init = prev
            c2w_t, loss_curve = self._solve(frame, init, self._track_device())
            if self.sync_method == "async":
                # The pose stays on the device: every consumer (warm start,
                # window, keyframes) is a device op, so nothing waits here.
                c2w = c2w_t
                self._track_loss_dev.append(loss_curve)
            else:
                c2w = c2w_t.cpu().numpy().astype(np.float32)
                self.track_losses.append(float(loss_curve[-1]))
        self.est_c2w.append(c2w)
        self.gt_c2w.append(
            None if frame.gt_c2w is None else np.asarray(frame.gt_c2w, np.float32)
        )
        return c2w

    def _track_map(self, td):
        """The device of a pose solve and the map it solves against: the
        main device's published map (``td`` None), or the tracker role's
        copy on ``td``."""
        if td is None:
            st = self.state
            return self.device, (st.decoders, st.grids, self.bounds, self.scene_bound)
        return td, self._track_snapshot(td)

    def _solve(self, frame: Frame, init: torch.Tensor, td=None):
        """The pose solve of ``frame`` from ``init`` on the published map,
        through the program of its device (``td``, the tracker role's, or
        the main one), on draws from the main generator; returns ``(c2w,
        losses)`` on the main device. Under a multi-rank runtime too: every
        rank holds the whole padded map and draws from the same generator
        state, so every rank solves the same pose, and the solve holds no
        collective."""
        dev, (decs, grids, bounds, sbound) = self._track_map(td)
        pixels = stack_draws(draw_track_pixels(self.gen, self.intr, self.tcfg, self.device), dev)
        prog = self._programs.track_program(dev, self.tcfg, self.intr, self.rcfg, decs, grids)
        c2w, losses = prog.run(decs, grids, bounds, sbound, frame.color.to(dev),
                               frame.depth.to(dev), init.to(dev), pixels)
        return c2w.to(self.device), losses.to(self.device)

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
                    # Overlap selection reads the percentages copied at the
                    # end of the previous event; the first overlap event
                    # (none computed yet) selects globally.
                    if self._overlap_pct is not None:
                        p = self._overlap_pct.numpy()
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
        if self.sync_method == "async":
            # Settle the previous event's guard before building on its map,
            # then snapshot what this event may change.
            self._verify_pending()
            self._event_prev = self._snapshot_event()
            self._event_passes = []
        # Read after the guard: a rollback may have replaced this frame's
        # pose, tracked against the faulty map.
        cur_c2w = self.est_c2w[-1]
        self._train_decoders_now = self.decoder_train == "always" or (
            self.decoder_train == "init" and first
        )
        if self.cfg.coarse and not first:
            self._run_mapper(frame, cur_c2w, m.iters, lr_factor, coarse=True,
                             refine=False, device=self._expert_device())
        for outer_i in range(outer):
            cur_c2w = self._run_mapper(
                frame, cur_c2w, iters, lr_factor, coarse=False,
                refine=(mode == "refine"), sel_salt=outer_i,
            )
        if self._ep_pending is not None:
            self._merge_coarse_expert()
        if self.sync_method == "async":
            self.est_c2w[-1] = cur_c2w
            passes = self._event_passes
            tails = torch.stack([torch.stack([lo[0], lo[-1]]) for *_, lo in passes])
            self._pending_verify = (
                self._event_prev, [p[:3] for p in passes], HostCopy(tails)
            )
            self._event_passes = self._event_prev = None
        else:
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
            i, j = draw_pixels(self.gen, self.intr, kf_mod.OVERLAP_PIXELS, device=self.device)
            self._overlap_pct = HostCopy(self._programs.overlap_percentages(
                self.intr, self._tensor(self.est_c2w[-1]), frame.depth,
                frame.color, self.state.keyframes.est_c2w, i, j,
            ))

    def _retrack_event_frame(self, frame: Frame):
        """One extra pose solve for the event frame against the fresh map."""
        c2w_t, _ = self._solve(frame, self._tensor(self.est_c2w[-1]))
        self.est_c2w[-1] = (
            c2w_t if self.sync_method == "async"
            else c2w_t.cpu().numpy().astype(np.float32)
        )

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

    def _kf_slice(self, pcfg: ProgConfig):
        """The runtime's slice of a pass (``MapKfRuntime.kf_slice``), or
        None without a runtime."""
        return None if self._runtime is None else self._runtime.kf_slice(pcfg.n_pixels)

    # ------------------------------------------------------------ precompile
    def _precompile_signatures(self):
        """Every ``(F, refine, ba)`` mapping signature a run can meet, as the
        JAX package's ``NiceSLAM._precompile_signatures`` lists them: the
        window, with BA when ``mapping.BA``, and the doubled refine window
        when ``mapping.color_refine``."""
        m = self.cfg.mapping
        W = m.mapping_window_size
        sigs = [(W, False, False)]
        if m.BA:
            sigs.append((W, False, True))
        if m.color_refine:
            sigs.append((2 * W, True, False))
            if m.BA:
                sigs.append((2 * W, True, True))
        return sigs

    def precompile(self):
        """Make every program a run can meet, and on a card capture its
        graphs, on dummy inputs, as the JAX package's ``precompile`` warms its
        programs: the pose solve's (unless ``tracking.gt_camera``), and for
        each of :meth:`_precompile_signatures` the graph of every stage its
        pass runs, the coarse pass's too on the window without BA (on the
        coarse expert's device when there is one). The dummies are ones for
        colors and depths, identity poses, every window slot valid and
        fixed, all-ones masks and pixel (0, 0) of slot 0: nothing is drawn
        from ``self.gen``, so a run's trajectory is the same with or without
        this. The keyframe programs too: the overlap over the keyframe
        capacity (with ``keyframe_selection_method: overlap``) and the frustum
        masks of every window size a pass with frustum feature selection
        meets. A signature met later (the first pass with decoders trained by
        ``mapping.decoder_train: init``) is captured when it is met. Under a
        multi-rank runtime the same, with the rank's sharded mapping programs
        (every segment of each stage, on its Z blocks with ``map > 1``),
        issuing no collective."""
        m = self.cfg.mapping
        H, W = self.intr.H, self.intr.W
        ones = lambda *shape: torch.ones(shape, device=self.device)  # noqa: E731
        eye = torch.eye(4, device=self.device)
        if not self.cfg.tracking.gt_camera:
            # The tracker role's solves, and the event frame's re-track on
            # the main device.
            roles = {self._track_device()} | ({None} if m.retrack else set())
            for td in roles:
                dev, (decs, grids, bounds, sbound) = self._track_map(td)
                prog = self._programs.track_program(
                    dev, self.tcfg, self.intr, self.rcfg, decs, grids)
                prog.warm(decs, grids, bounds, sbound, ones(H, W, 3).to(dev),
                          ones(H, W).to(dev), eye.to(dev),
                          torch.zeros((self.tcfg.iters, 2, self.tcfg.pixels),
                                      dtype=torch.long, device=dev))
        st = self.state
        sigs = self._precompile_signatures()
        self._programs.warm_keyframe_programs(
            self.intr, self._bounds_host, st.grids, st.keyframes.est_c2w,
            sorted({F for F, refine, _ in sigs if m.frustum_feature_selection and not refine}),
            m.keyframe_selection_method == "overlap")
        for F, refine, ba in sigs:
            mcfg = self._make_mcfg(ba, refine, 1.0)
            pcfg = self._make_pcfg(mcfg)
            ratios = (0.0, 0.0) if refine else (m.middle_iter_ratio, m.fine_iter_ratio)
            passes = [(self.device, build_stage_plan(m.iters, *ratios, m.stage_lr))]
            if self.cfg.coarse and not (refine or ba):
                passes.append((self._expert_device() or self.device,
                               build_stage_plan(m.iters, *ratios, m.stage_lr, coarse=True)))
            for dev, plan in passes:
                sched = schedule_arrays(plan, mcfg)
                rows = max(m.iters, m.bootstrap_iters)
                if not (refine or ba or plan[0][0] == "coarse"):
                    rows = max(rows, m.iters_first)
                grids, decoders, bounds = (_tree_to(t, dev) for t in (st.grids, st.decoders,
                                                                       self.bounds))
                grids = self._blocks(grids)
                cams = tensor_from_camera(eye.expand(F, 4, 4)).to(dev)
                masks = {lvl: torch.ones(g.shape[:3] + (1,), device=dev)
                         for lvl, g in grids.items()}
                prog = self._programs.map_program(
                    (F, refine, ba), dev, pcfg, self.intr, self.rcfg, grids, decoders, cams,
                    rows=rows, kf=self._kf_slice(pcfg))
                prog.warm(grids, decoders, cams, masks, bounds, self.scene_bound.to(dev),
                          ones(F, H, W, 3).to(dev), ones(F, H, W).to(dev),
                          np.ones((F,), bool), np.ones((F,), bool), sched,
                          torch.zeros((len(sched), 3, pcfg.n_pixels), dtype=torch.long,
                                      device=dev))

    def _run_mapper(
        self, frame: Frame, cur_c2w, iters, lr_factor, coarse: bool,
        refine: bool, sel_salt: int = 0, device=None,
    ):
        """One mapping pass; on ``device`` (the coarse stage expert) it is
        held back for :meth:`_merge_coarse_expert`."""
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
        sel = np.zeros((F,), np.int64)
        sel[:wcur] = slots
        sel = to_device(sel, self.device)
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
            masks = self._programs.frustum_masks(
                poses44, to_device(valid, self.device), depths,
                self.intr, self._bounds_host, grids,
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
        new_grids, new_decoders, new_cams, losses = self._map_pass(
            (F, refine, ba), plan, mcfg, pcfg, grids, masks, self.state.decoders, cams,
            colors, depths, valid, fixed, device)
        if self.fault_hook is not None:
            new_grids, new_decoders, new_cams, losses = self.fault_hook(
                idx, (new_grids, new_decoders, new_cams, losses)
            )
        stages = [p[0] for p in plan]
        if device is not None:
            losses = losses.to(self.device)
            self._ep_pending = (
                idx, stages, new_grids["coarse"].detach(),
                _detach_tree(new_decoders["coarse"]), losses,
            )
            if self.sync_method == "async":
                self._event_passes.append((idx, coarse, stages, losses))
            return cur_c2w
        if self.sync_method == "async":
            # Published at once; checked at the next event (_verify_pending).
            self._event_passes.append((idx, coarse, stages, losses))
        else:
            losses_np = losses.cpu().numpy()
            # NaN guard: a diverged pass is never published.
            if not np.isfinite(losses_np[-1]):
                self.log.log({
                    "event": "map_rejected", "frame": idx, "coarse": coarse,
                    "loss_last": float(losses_np[-1]),
                })
                return cur_c2w
            self.log.log({
                "event": "map", "frame": idx, "coarse": coarse, "stages": stages,
                "loss_first": float(losses_np[0]), "loss_last": float(losses_np[-1]),
            })
        self.state.grids = {k: v.detach() for k, v in new_grids.items()}
        self.state.decoders = _detach_tree(new_decoders)
        if ba:
            # Write the optimized keyframe poses back.
            new_poses = to_homogeneous(camera_from_tensor(new_cams.detach()))
            for w, s in enumerate(slots):
                if not fixed[w]:
                    db.est_c2w[s] = new_poses[w]
            if not fixed[wcur]:
                if self.sync_method == "async":
                    return new_poses[wcur]
                return new_poses[wcur].cpu().numpy()
        return cur_c2w

    def _map_pass(self, signature, plan, mcfg: MapOptConfig, pcfg: ProgConfig, grids, masks,
                  decoders, cams, colors, depths, valid: np.ndarray, fixed: np.ndarray,
                  device=None):
        """One mapping pass of ``plan`` through the system's mapping program
        of ``signature``, on ``device`` (the coarse expert) when given:
        every row's draws up front, on the main generator, in row order.
        Under a runtime with more than one map block the program runs on
        this rank's Z blocks and the grids come back assembled. Returns new
        ``(grids, decoders, cams, losses)``."""
        sched = schedule_arrays(plan, mcfg)
        dev = self.device if device is None else device
        valid_idx = to_device(np.flatnonzero(valid), self.device)
        pixels = stack_draws([
            draw_mapping_pixels(self.gen, valid_idx, pcfg.n_pixels, self.intr, self.device)
            for _ in range(len(sched))
        ], dev)
        bounds, scene_bound = self.bounds, self.scene_bound
        if device is not None:
            grids, masks, decoders, bounds = (
                _tree_to(t, device) for t in (grids, masks, decoders, bounds)
            )
            cams, colors, depths, scene_bound = (
                t.to(device) for t in (cams, colors, depths, scene_bound)
            )
        grids, masks = self._blocks(grids), self._blocks(masks)
        prog = self._programs.map_program(
            signature, dev, pcfg, self.intr, self.rcfg, grids, decoders, cams,
            rows=len(sched), kf=self._kf_slice(pcfg))
        new_grids, new_decoders, new_cams, losses = prog.run(
            grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
            valid, fixed, sched, pixels)
        return self._assembled(new_grids), new_decoders, new_cams, losses

    def _blocks(self, tree):
        """This rank's Z blocks of every level (``MapKfRuntime.split``) under a
        runtime with more than one map block; else ``tree`` itself."""
        rt = self._runtime
        return tree if rt is None or rt.mesh.n_map == 1 else rt.split(tree)

    def _assembled(self, blocks):
        """The whole grids from the map group's blocks (``MapKfRuntime.
        assemble``), the inverse of :meth:`_blocks`."""
        rt = self._runtime
        return blocks if rt is None or rt.mesh.n_map == 1 else rt.assemble(blocks)

    def _merge_coarse_expert(self):
        """Publish the coarse expert's pass after the staged pass: its level
        and decoder back on the main device. In strict sync its NaN guard
        runs here; in async the event's guard covers it."""
        idx, stages, g_c, d_c, losses = self._ep_pending
        self._ep_pending = None
        if self.sync_method != "async":
            lo = losses.cpu().numpy()
            if not np.isfinite(lo[-1]):
                self.log.log({
                    "event": "map_rejected", "frame": idx, "coarse": True,
                    "loss_last": float(lo[-1]),
                })
                return
            self.log.log({
                "event": "map", "frame": idx, "coarse": True, "stages": stages,
                "loss_first": float(lo[0]), "loss_last": float(lo[-1]),
            })
        self.state.grids = {**self.state.grids, "coarse": g_c.to(self.device)}
        self.state.decoders = {**self.state.decoders, "coarse": _tree_to(d_c, self.device)}

    # ------------------------------------------------------------ async guard
    def _snapshot_event(self):
        """What a mapping event may change, taken before it starts. Published
        grids and decoders are replaced, never written, so a reference keeps
        them; the keyframe DB is written in place, so its poses, indices and
        the slot an admission would fill are copied."""
        return (
            self.state.grids,
            self.state.decoders,
            snapshot_keyframes(self.state.keyframes),
            self._kf_count,
            self._kf_slot_frame.copy(),
            len(self.est_c2w) - 1,
            self.est_c2w[-1],
            None if self._obs_counts is None else dict(self._obs_counts),
        )

    def _verify_pending(self):
        """Resolve the deferred NaN guard of the last async mapping event:
        log its passes, or, if any pass diverged, roll the whole event back
        (passes within one event build on each other, so a partial
        acceptance would keep poisoned state)."""
        if self._pending_verify is None:
            return
        prev, passes, tails = self._pending_verify
        self._pending_verify = None
        tails = tails.numpy()  # [passes, (first, last)]
        if np.isfinite(tails[:, 1]).all():
            for (idx, coarse, stages), (first, last) in zip(passes, tails):
                self.log.log({
                    "event": "map", "frame": idx, "coarse": coarse, "stages": stages,
                    "loss_first": float(first), "loss_last": float(last),
                })
            return
        grids, decoders, kf_snap, kf_count, kf_slots, tidx, tpose, obs = prev
        self.state.grids, self.state.decoders = grids, decoders
        self._track_snap = None
        restore_keyframes(self.state.keyframes, kf_snap)
        self._kf_count, self._kf_slot_frame, self._obs_counts = kf_count, kf_slots, obs
        # The event frame's pose as it was (BA may have poisoned it); a later
        # pose tracked against the faulty map is held at the last finite one.
        self.est_c2w[tidx] = last = tpose
        for k in range(tidx + 1, len(self.est_c2w)):
            last = self.est_c2w[k] = self._finite_or(self.est_c2w[k], last)
        self.log.log({
            "event": "map_rejected", "frame": passes[0][0],
            "loss_last": [float(t) for t in tails[:, 1]],
        })

    def _finite_or(self, pose, fallback):
        """``pose`` if all its entries are finite, else ``fallback``; on the
        device for a tensor (no read back)."""
        if isinstance(pose, torch.Tensor):
            return torch.where(torch.isfinite(pose).all(), pose, self._tensor(fallback))
        return pose if np.isfinite(pose).all() else fallback

    def flush(self):
        """Settle everything deferred: the pending guard, the track-loss
        curves, and the poses (numpy from here on)."""
        self._verify_pending()
        if self._track_loss_dev:
            tails = torch.stack([c[-1] for c in self._track_loss_dev]).cpu().numpy()
            self.track_losses.extend(float(t) for t in tails)
            self._track_loss_dev = []
        self.est_c2w = [
            p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p, np.float32)
            for p in self.est_c2w
        ]

    # ------------------------------------------------------------------ run
    def step(self, frame: Frame):
        """Process one frame: track, then map if scheduled, then write a
        render panel if ``vis_dir`` is set and the frame is due."""
        idx = len(self.est_c2w)
        t0 = time.perf_counter()
        first = idx == 0
        # One host-to-device copy per frame, shared by track and map (none
        # for a frame the prefetcher already put on the device).
        frame = Frame(
            idx=frame.idx,
            color=self._tensor(frame.color),
            depth=self._tensor(frame.depth),
            gt_c2w=frame.gt_c2w,
        )
        with self.timer.section("track"), annotate("track"):
            self.track(frame)
        t_track = time.perf_counter()
        m = self.cfg.mapping
        if (
            first
            or idx < m.bootstrap_frames
            or idx % m.every_frame == 0
            or idx == self.n_imgs - 1
        ):
            with self.timer.section("map"), annotate("map"):
                self.map_frame(frame, first=first)
        t_map = time.perf_counter()
        if (
            self.vis_dir
            and idx % max(m.vis_freq, 1) == 0
            and not (idx == 0 and self.cfg.tracking.no_vis_on_first_frame)
        ):
            save_frame_vis(
                self.vis_dir, idx, self.state.decoders, self.state.grids,
                self.bounds, self.scene_bound, self.intr, self._tensor(self.est_c2w[-1]),
                frame.color, frame.depth, self.rcfg,
            )
        t_end = time.perf_counter()
        self.log.frame_done()
        # Host clocks: strict sync reads the pose and the mapping losses back
        # before each section ends, so they cover the device work; async
        # sync covers what the host spent queueing it.
        self.log.log({
            "event": "frame", "frame": idx,
            "dt": round(t_end - t0, 4),
            "dt_track": round(t_track - t0, 4),
            "dt_map": round(t_map - t_track, 4),
            "fps_avg": round(self.log.fps, 3),
            "track_loss": (
                self.track_losses[-1]
                if idx > 0 and self.track_losses and self.sync_method != "async"
                else None
            ),
        })

    def run(self, n_frames: Optional[int] = None):
        n = len(self.reader) if n_frames is None else min(n_frames, len(self.reader))
        self.n_imgs = n
        pf = Prefetcher(self.reader, device=self.device, end=n)
        try:
            for frame in pf:
                self.step(frame)
        finally:
            pf.close()
        return self.result()

    def restore(self, ckpt_path: str) -> int:
        """Resume from a checkpoint (``utils/checkpoint.py``): the map, the
        keyframe DB, the bounds and the trajectory; returns the next frame
        index. The keyframe DB's host mirrors are rebuilt from the DB."""
        payload = load_checkpoint(ckpt_path, self.device)
        self.state = payload["state"]
        if payload["bounds"] is not None:
            self._set_bounds(
                payload["bounds"],
                self.scene_bound if payload["scene_bound"] is None
                else payload["scene_bound"],
            )
        # A snapshot keeps its grids' Z padding (and the bounds that go with
        # it): it restores at any map extent, re-padded here when attached.
        if self._runtime is not None:
            self._runtime.reattach_grids(self)
        self._fit_obs_counts()
        self._track_snap = None
        self.est_c2w = payload["est_c2w"]
        self.gt_c2w = payload["gt_c2w"]
        self._kf_count = int(self.state.keyframes.count)
        self._kf_slot_frame = self.state.keyframes.frame_idx.cpu().numpy().astype(np.int64)
        self._pending_verify = None
        self._track_loss_dev = []
        return payload["frame_idx"] + 1

    def result(self):
        self.flush()
        out = {"est_c2w": self.est_c2w, "gt_c2w": self.gt_c2w}
        gts = [g for g in self.gt_c2w if g is not None]
        if len(gts) == len(self.est_c2w) and len(gts) > 1:
            out["ate_rmse"] = ate_rmse(self.est_c2w, gts)
        return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach_tree(v) for v in tree)
    return tree.detach()
