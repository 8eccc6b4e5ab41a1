"""What decides ``correct``: the port's own answers from the window, held to
the plain reference in ``benchmark/reference``.

:class:`Recorder` wraps three of the system's calls on its instance: the
pose solve (``NiceSLAM._solve``), the mapping pass (``NiceSLAM._map_pass``)
and the frustum masks (``Programs.frustum_masks``). Each wrapper reads the
pixel generator's state before the call and keeps references to the call's
inputs and outputs (the system replaces its published map and never writes
it in place, so a reference keeps what the call read). It counts every
solve and every mapping row, and while ``on`` it keeps a sample drawn from
the seed: ``k_solves`` solves and one mapping event (all its passes), each
uniformly over the window's, by reservoir sampling. Nothing it does waits
for the card.

:func:`reference_answers` recomputes each sampled answer from the same
state: the reference draws the same pixels from the recorded generator
state and hands them to the configuration's model family
(``benchmark/families``), whose plain reference works the bounds, masks and
learning rates out from the configuration and starts from the map the call
read (the program's state: the reference follows the run step by step).
:func:`gaps` turns the two sides into the numbers that are compared:

- ``start_gap``: the largest difference between the map the system starts
  from and the one the family's reference builds from the seed and its
  files (exact: limit 0);
- ``track_loss_gap``: the largest relative gap of a sampled solve's robust
  loss at its first :data:`LOSS_ROWS` iterations (the render at the warm
  start, then the first Gauss-Newton steps);
  The solve's final pose is logged, not compared: a solve is 50 iterations
  on fresh pixels, each step clipped to 2 cm, and where the track is poor
  the steps stay at the clip and the walk does not contract, so two sound
  runs can end centimetres apart while the TF32 control ends millimetres
  apart;
- ``map_first_gap``: the largest relative gap of a sampled pass's loss at
  its first iteration, the forward pass alone from the map the pass read
  (the numbers separate most widely there);
- ``map_loss_gap``: the largest relative gap of a sampled pass's loss at
  its first :data:`LOSS_ROWS` iterations (the forward pass, then the first
  gradients and Adam steps);
- ``map_change_gap``: over the sampled passes, the worst parameter group's
  gap between the norms of its change over the whole pass, against the
  reference's norm of that group or of the median group, whichever is
  larger. The groups are the family's optimiser groups (for NICE-SLAM: each
  grid level, the trained decoders, the window cameras). Groups whose first
  gradient in the reference is under a thousandth of the median group's are
  left out.

What the reference runs is worked out from the configuration and the frame
index, never read from the program: which frames map, the passes of an
event (the family's: for NICE-SLAM the coarse pass, then the staged pass),
each pass's iterations and stage split, its learning-rate factor, whether
it adjusts the window's cameras (bundle adjustment, BA) and which of them
stay pinned. Three exact numbers (limit 0) hold the program to that
schedule and to its own state:

- ``schedule_gap``: over every frame of the window, the calls the program
  made (each solve with its loss rows; each pass with its stages, rows,
  learning-rate factor and BA flag) against those the configuration
  implies, counting each one that differs, is missing or is extra;
- ``window_gap``: over the sampled event's passes, each window slot that
  does not hold the stream's frame of a keyframe the configuration admitted
  (or, in the last valid slot, the event's own frame), a keyframe held
  twice, the newest keyframe left out, a window of another size than the
  configuration's, and a pinned set other than BA's (all pinned without BA;
  with it, the unused slots and the oldest keyframe);
- ``chain_gap``: the largest difference between the map (grids and
  decoders) that a sampled solve or pass read and the one that the pass
  before it returned: a pass whose result the program does not commit
  leaves the next call reading a stale map.
"""
from __future__ import annotations

import contextlib
import random
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import mapper as ref_mapper
from ..reference import render as R
from ..reference import tracker as ref_tracker


# The loss rows of a pass or solve that are compared: the staged pass's
# middle stage steps at a learning rate of 0.1, and Adam's steps of about
# that size on features that rounding moves apart amplify a gap of 1e-7
# ~10x an iteration; by the end of the pass two sound runs differ by a few
# percent.
LOSS_ROWS = 3


class Recorder:
    def __init__(self, slam, seed: int, k_solves: int = 3):
        self.slam = slam
        self.rng = random.Random(seed)
        self.k_solves = k_solves
        self.on = False
        self.solves = 0
        self.rows: List[tuple] = []
        self.sampled_solves: List[dict] = []
        self.sampled_event: List[dict] = []
        self._seen_solves = 0
        self._seen_events = 0
        self._event_frame = None
        self._keep_event = False
        self._frustum = None
        # Every call of the window: ("solve", frame, loss rows) or ("pass",
        # frame, stages, rows, learning-rate factor, BA).
        self.calls: List[tuple] = []
        # The map the last pass returned: what the next call has to read.
        self._last = (slam.state.grids, slam.state.decoders)
        self._orig = (slam._solve, slam._map_pass, slam._programs.frustum_masks)
        slam._solve = self._solve
        slam._map_pass = self._map_pass
        slam._programs.frustum_masks = self._frustum_masks

    def detach(self):
        """Give the system its own methods back and drop the reference to it."""
        slam = self.slam
        slam._solve, slam._map_pass, slam._programs.frustum_masks = self._orig
        self._orig = None
        self.slam = None

    def _solve(self, frame, init, td=None):
        state = self.slam.gen.get_state()
        grids, decoders = self.slam.state.grids, self.slam.state.decoders
        c2w, losses = self._orig[0](frame, init, td)
        self.solves += 1
        if self.on:
            self.calls.append(("solve", frame.idx, int(losses.shape[0])))
            self._seen_solves += 1
            item = dict(gen=state, grids=grids, decoders=decoders, color=frame.color,
                        depth=frame.depth, init=init, pose=c2w, losses=losses,
                        expect=self._last)
            if len(self.sampled_solves) < self.k_solves:
                self.sampled_solves.append(item)
            else:
                k = self.rng.randrange(self._seen_solves)
                if k < self.k_solves:
                    self.sampled_solves[k] = item
        return c2w, losses

    def _frustum_masks(self, poses, pose_valid, depths, *rest):
        self._frustum = poses
        return self._orig[2](poses, pose_valid, depths, *rest)

    def _map_pass(self, signature, plan, mcfg, pcfg, grids, masks, decoders, cams, colors,
                  depths, valid, fixed, device=None):
        state = self.slam.gen.get_state()
        poses, self._frustum = self._frustum, None
        out = self._orig[1](signature, plan, mcfg, pcfg, grids, masks, decoders, cams, colors,
                            depths, valid, fixed, device)
        self.rows += [(stage, bool(signature[2])) for stage, n, _ in plan for _ in range(n)]
        expect, self._last = self._last, (out[0], out[1])
        if self.on:
            frame = len(self.slam.est_c2w) - 1
            self.calls.append(("pass", frame, tuple((stage, n) for stage, n, _ in plan),
                               int(out[3].shape[0]), float(mcfg.lr_factor), bool(signature[2])))
            if frame != self._event_frame:
                self._event_frame = frame
                self._seen_events += 1
                self._keep_event = self.rng.randrange(self._seen_events) == 0
                if self._keep_event:
                    self.sampled_event = []
            if self._keep_event:
                self.sampled_event.append(dict(
                    gen=state, frame=frame, grids=grids, decoders=decoders, cams=cams,
                    colors=colors, depths=depths, valid=np.array(valid),
                    fixed=np.array(fixed), poses=poses, expect=expect, out=out))
        return out


@contextlib.contextmanager
def tf32(on: bool):
    """Matrix products in TF32 (``on``) or in full float32 inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _is_mapping_frame(m: dict, idx: int) -> bool:
    return idx == 0 or idx < m["bootstrap_frames"] or idx % m["every_frame"] == 0


def keyframes_before(m: dict, idx: int) -> List[int]:
    """The frames admitted as keyframes before frame ``idx``'s mapping event:
    mapping frames that are a multiple of ``keyframe_every`` or bootstrap
    frames (the stream has no last frame)."""
    return [j for j in range(idx) if _is_mapping_frame(m, j)
            and (j % m["keyframe_every"] == 0 or j < m["bootstrap_frames"])]


def _runs(stages: List[str]) -> tuple:
    out: List[list] = []
    for st in stages:
        if out and out[-1][0] == st:
            out[-1][1] += 1
        else:
            out.append([st, 1])
    return tuple((st, n) for st, n in out)


def expected_passes(cfg: dict, fam, idx: int, force: bool = False) -> List[dict]:
    """The mapping passes the configuration runs at frame ``idx`` (not the
    first, on a stream with no last frame), as the family ``fam`` plans an
    event (for NICE-SLAM the coarse pass when the configuration has one,
    then the staged pass), each with its stage runs (``stages``) and the
    keyframes the store holds (``kf``); with ``force`` those it would run
    there were ``idx`` a mapping frame."""
    m = cfg["mapping"]
    if not force and (idx == 0 or not _is_mapping_frame(m, idx)):
        return []
    iters = m["iters"]
    if idx < m["bootstrap_frames"] and m["bootstrap_iters"] > 0:
        iters = m["bootstrap_iters"]
    admitted = keyframes_before(m, idx)
    # The keyframe store keeps the newest ``max_keyframes``.
    kf = admitted[-m["max_keyframes"]:]
    out = fam.passes(cfg, iters, len(admitted))
    for p in out:
        p["stages"], p["kf"] = _runs(p["plan"]), kf
    return out


def expected_calls(cfg: dict, fam, idx: int) -> List[tuple]:
    """Frame ``idx``'s calls in :attr:`Recorder.calls`' form: the pose solve
    (unless the poses are given), the mapping passes, the re-track solve."""
    m, t = cfg["mapping"], cfg["tracking"]
    solve = ("solve", idx, t["iters"])
    passes = expected_passes(cfg, fam, idx)
    out = [] if t["gt_camera"] or idx == 0 else [solve]
    out += [("pass", idx, p["stages"], p["iters"], p["lr_factor"], p["ba"]) for p in passes]
    if passes and m["retrack"] and not t["gt_camera"]:
        out.append(solve)
    return out


def _pass_spec(cfg: dict, fam, p: dict, k: int) -> dict:
    """What the configuration makes of a sampled event's ``k``-th pass (a
    pass the schedule has not is :func:`schedule_gap`'s to count)."""
    exp = expected_passes(cfg, fam, p["frame"], force=True)
    return exp[min(k, len(exp) - 1)]


def schedule_gap(rec: Recorder, cfg: dict, fam, frames) -> int:
    """The window's calls that differ from the configuration's schedule for
    ``frames``, are missing or are extra."""
    made: Dict[int, List[tuple]] = {}
    for c in rec.calls:
        made.setdefault(c[1], []).append(c)
    gap = 0
    for idx in frames:
        want, got = expected_calls(cfg, fam, idx), made.pop(idx, [])
        gap += sum(a != b for a, b in zip(want, got)) + abs(len(want) - len(got))
    return gap + sum(len(v) for v in made.values())


def window_gap(rec: Recorder, cfg: dict, fam, frame_of) -> tuple:
    """``(gap, fixed)``: the count of window faults of the sampled event's
    passes (see the module's text) and each pass's pinned set as the
    configuration has it. ``frame_of(j)`` is the stream's ``(color, depth)``
    of frame ``j``."""
    m = cfg["mapping"]
    gap, fixed_all = 0, []
    for k, p in enumerate(rec.sampled_event):
        e = _pass_spec(cfg, fam, p, k)
        valid = p["valid"]
        n = int(valid.sum())
        gap += int(len(valid) != m["mapping_window_size"]) + int(not valid[:n].all())
        cur = n - 1
        c, d = frame_of(p["frame"])
        gap += int(not (torch.equal(p["colors"][cur], c) and torch.equal(p["depths"][cur], d)))
        # The keyframes each slot may hold: a stream that wraps repeats a frame.
        cands = [[j for j in e["kf"] if torch.equal(p["colors"][w], frame_of(j)[0])
                  and torch.equal(p["depths"][w], frame_of(j)[1])] for w in range(cur)]
        gap += sum(not c for c in cands)
        for key, count in Counter(tuple(c) for c in cands if c).items():
            gap += max(0, count - len(key))
        fixed = np.ones_like(valid)
        if e["kf"]:
            gap += int(not any(e["kf"][-1] in c for c in cands))
            most = min(m["mapping_window_size"] - 2, len(e["kf"]) - 1) + 1
            gap += int(cur != most) if e["coarse"] else int(not 1 <= cur <= most)
        if e["ba"]:
            fixed = ~valid
            held = [j for c in cands for j in c]
            if held:
                at = [w for w, c in enumerate(cands) if min(held) in c]
                fixed[next((w for w in at if p["fixed"][w]), at[0])] = True
        gap += int(not np.array_equal(fixed, p["fixed"]))
        fixed_all.append(fixed)
    return gap, fixed_all


def _maxdiff(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.detach() - b.detach()).abs().max()) if a.numel() else 0.0


def chain_gap(rec: Recorder) -> float:
    """Largest difference between the map a sampled call read and the map
    the pass before it returned."""
    gap = 0.0
    for item in rec.sampled_solves + rec.sampled_event:
        grids, decoders = item["expect"]
        for lvl, g in grids.items():
            gap = max(gap, _maxdiff(item["grids"][lvl], g))
        read = dict(R.leaves(item["decoders"]))
        for path, leaf in R.leaves(decoders):
            gap = max(gap, _maxdiff(read[path], leaf) if path in read else float("inf"))
    return gap


def start_gap(cfg: dict, fam, seed: int, grids0: Dict[str, torch.Tensor], dec0,
              root) -> float:
    """Largest difference between the map the system starts from and the
    one the family ``fam`` builds from the seed and its files under
    ``root``."""
    ref, ref_dec = fam.initial_map(cfg, seed, root)
    gap = 0.0
    for lvl, g in ref.items():
        p = grids0[lvl].detach().cpu()
        gap = max(gap, float("inf") if p.shape != g.shape else float((p - g).abs().max()))
    dec = dict(R.leaves(ref_dec))
    for path, leaf in R.leaves(dec0):
        p = leaf.detach().cpu()
        r = dec.get(path)
        gap = max(gap, float("inf") if r is None or r.shape != p.shape
                  else float((p - r).abs().max()))
    return gap


def reference_answers(rec: Recorder, cfg: dict, fam, device, fixed: List[np.ndarray],
                      use_tf32: bool = False, half_batch: bool = False) -> dict:
    """The family's reference answer to every sampled solve and pass, each
    pass on the schedule and pinned set (``fixed``, from :func:`window_gap`)
    that the configuration gives it; with ``half_batch`` a planted fault:
    each iteration uses the first half of its pixels, its loss doubled."""
    cam = R.camera(cfg["cam"])
    t, m = cfg["tracking"], cfg["mapping"]
    out = {"solves": [], "passes": []}
    with tf32(use_tf32):
        for s in rec.sampled_solves:
            gen = torch.Generator(device=device)
            gen.set_state(s["gen"])
            draws = ref_tracker.draw(gen, cam, t["pixels"], t["iters"], t["ignore_edge_H"],
                                     t["ignore_edge_W"], device)
            if half_batch:
                draws = [(i[:len(i) // 2], j[:len(j) // 2]) for i, j in draws]
            pose, losses = fam.solve(cfg, s, draws, device)
            out["solves"].append((pose, losses * (2.0 if half_batch else 1.0)))
        for k, p in enumerate(rec.sampled_event):
            e = _pass_spec(cfg, fam, p, k)
            gen = torch.Generator(device=device)
            gen.set_state(p["gen"])
            draws = ref_mapper.draw(gen, p["valid"], m["pixels"], e["iters"], cam, device)
            if half_batch:
                draws = [tuple(x[:len(x) // 2] for x in d) for d in draws]
            out["passes"].append(fam.map_pass(cfg, p, e, fixed[k], draws, device,
                                              loss_scale=2.0 if half_batch else 1.0))
            out.setdefault("ba", []).append(e["ba"])
            out.setdefault("coarse", []).append(e["coarse"])
    return out


def _first_by_group(first: Dict[tuple, float]) -> Dict[tuple, float]:
    """The reference's first-gradient norms of the family's groups: a
    leaf's group is its key's first two entries."""
    out: Dict[tuple, float] = {}
    for key, norm in first.items():
        g = key[:2]
        out[g] = float(np.hypot(out.get(g, 0.0), norm))
    return out


def _rel_rows(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each loss row's gap relative to the reference's; every row infinite
    where the program ran another number of rows."""
    if p.shape != r.shape:
        return torch.full((max(len(r), 1),), float("inf"), dtype=torch.float64)
    return (p - r).abs() / r.abs().clamp(min=1e-12)


def gaps(rec: Recorder, cfg: dict, fam, ref: dict, program: Optional[dict] = None,
         log=lambda *a: None) -> Dict[str, float]:
    """The compared numbers of the sampled answers: the program's (or, for
    the control, ``program``: another reference's) against ``ref``; the
    parameter groups are the family ``fam``'s."""
    out: Dict[str, float] = {}
    if rec.sampled_solves:
        lg = 0.0
        for k, (pose_r, loss_r) in enumerate(ref["solves"]):
            pose_p, loss_p = (program["solves"][k] if program else
                              (rec.sampled_solves[k]["pose"], rec.sampled_solves[k]["losses"]))
            pose_p, pose_r = pose_p.detach().double().cpu(), pose_r.double().cpu()
            gap = float(torch.linalg.norm(pose_p[:3, 3] - pose_r[:3, 3])) * 1e3
            loss_p, loss_r = loss_p.detach().double().cpu(), loss_r.double().cpu()
            rel = _rel_rows(loss_p, loss_r)
            lg = max(lg, float(rel[:LOSS_ROWS].max()))
            log(f"solve {k}: pose gap {gap:.4e} mm, loss gap rows 1-{LOSS_ROWS} "
                f"{float(rel[:LOSS_ROWS].max()):.3e}, all rows {float(rel.max()):.3e}")
        out["track_loss_gap"] = lg
    if rec.sampled_event:
        lg = cg = fg1 = 0.0
        for k, p in enumerate(rec.sampled_event):
            g_r, d_r, c_r, l_r, first = ref["passes"][k]
            if program:
                g_p, d_p, c_p, l_p, _ = program["passes"][k]
            else:
                g_p, d_p, c_p, l_p = p["out"]
            l_p, l_r = l_p.detach().double().cpu(), l_r.double().cpu()
            rel = _rel_rows(l_p, l_r)
            lg = max(lg, float(rel[:LOSS_ROWS].max()))
            fg1 = max(fg1, float(rel[0]))
            ba, coarse = ref["ba"][k], ref["coarse"][k]
            start = fam.groups(p["grids"], p["decoders"], p["cams"], cfg, ba)
            new_r = fam.groups(g_r, d_r, c_r, cfg, ba)
            new_p = fam.groups(g_p, d_p, c_p, cfg, ba)
            dev = next(iter(new_r.values())).device
            dr = {g: float(torch.linalg.norm((new_r[g].to(dev) - start[g].to(dev)).double()))
                  for g in start}
            dp = {g: float(torch.linalg.norm((new_p[g].to(dev) - start[g].to(dev)).double()))
                  for g in start}
            fg = _first_by_group(first)
            moved = [g for g in start if dr[g] > 0]
            if moved:
                gmed = float(np.median([fg.get(g, 0.0) for g in moved]))
                keep = [g for g in moved if fg.get(g, 0.0) >= 1e-3 * gmed]
                dmed = float(np.median([dr[g] for g in keep]))
                per = {g: abs(dp[g] - dr[g]) / max(dr[g], dmed) for g in keep}
                cg = max([cg] + list(per.values()))
            else:
                per = {}
            log(f"pass {k} ({'coarse' if coarse else 'staged'}, ba {ba}): loss gap rows "
                f"1-{LOSS_ROWS} {float(rel[:LOSS_ROWS].max()):.3e}, all rows "
                f"{float(rel.max()):.3e}; change gaps "
                + ", ".join(f"{'/'.join(g)} {v:.3e}" for g, v in per.items()))
        out["map_first_gap"], out["map_loss_gap"], out["map_change_gap"] = fg1, lg, cg
    return out
