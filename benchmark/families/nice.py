"""NICE-SLAM's hierarchical feature grid: four grid levels (coarse, middle,
fine, colour) sampled trilinearly, the shipped decoder MLPs over the
Fourier embedding, occupancy compositing. Its plain reference is
``benchmark/reference/{render,tracker,mapper}.py`` and its yardstick
``harness/costs.py``. The interface is ``benchmark/families/__init__.py``'s.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import costs
from benchmark.reference import mapper as ref_mapper
from benchmark.reference import render as R
from benchmark.reference import tracker as ref_tracker

__all__ = ["costs", "files", "groups", "initial_map", "map_pass", "passes", "solve"]


def trained_decoders(m: dict) -> List[str]:
    """The decoder levels a pass trains with the shipped (frozen) decoders:
    fine unless ``fix_fine``, colour unless ``fix_color``, where some stage
    gives them a learning rate."""
    lrs = [m[f"stage_{s}"]["decoders_lr"] for s in ("coarse", "middle", "fine", "color")]
    out = []
    for lvl, fixed in (("fine", m["fix_fine"]), ("color", m["fix_color"])):
        if not fixed and any(lr != 0 for lr in lrs):
            out.append(lvl)
    return out


def files(cfg: dict, root: Path) -> Dict[str, str]:
    return {"pretrained_middle_fine": str(Path(root) / cfg["pretrained_middle_fine"])}


def initial_map(cfg: dict, seed: int, root: Path):
    """Grids from the seed, decoders from the shipped file."""
    grids = R.init_grids(cfg["bound"], cfg["grid_len"], cfg["model"]["c_dim"],
                         cfg["model"]["coarse_bound_enlarge"], seed)
    return grids, R.load_npz_decoders(files(cfg, root)["pretrained_middle_fine"], "cpu")


def passes(cfg: dict, iters: int, admitted: int) -> List[dict]:
    """The coarse pass when the configuration has one (``mapping.iters``
    iterations, never BA), then the staged pass: middle, fine, colour."""
    m = cfg["mapping"]
    out = []
    if cfg["coarse"]:
        out.append(dict(coarse=True, iters=m["iters"], lr_factor=float(m["lr_factor"]),
                        ba=False))
    out.append(dict(coarse=False, iters=iters, lr_factor=float(m["lr_factor"]),
                    ba=bool(m["BA"]) and admitted > m["BA_min_keyframes"]))
    for p in out:
        p["plan"] = ref_mapper.stage_plan(p["iters"], p["coarse"], m["middle_iter_ratio"],
                                          m["fine_iter_ratio"])
    return out


def _bounds(cfg: dict, device):
    return R.level_bounds(cfg["bound"], cfg["grid_len"]["bound_divisable"],
                          cfg["model"]["coarse_bound_enlarge"], device)


def solve(cfg: dict, s: dict, draws, device):
    r, t = cfg["rendering"], cfg["tracking"]
    sb, bounds = _bounds(cfg, device)
    return ref_tracker.gn_solve(
        R.tree_to(s["decoders"], device), R.tree_to(s["grids"], device), bounds, sb,
        R.camera(cfg["cam"]), s["color"], s["depth"], s["init"].to(device), draws, t,
        r["N_samples"], r["N_surface"])


def map_pass(cfg: dict, p: dict, e: dict, fixed: np.ndarray, draws, device,
             loss_scale: float = 1.0):
    r, m = cfg["rendering"], cfg["mapping"]
    sb, bounds = _bounds(cfg, device)
    return ref_mapper.map_pass(
        p["grids"], p["decoders"], p["cams"], p["poses"], p["colors"], p["depths"],
        p["valid"], fixed, bounds, sb, R.camera(cfg["cam"]), m, e["coarse"], e["iters"],
        e["lr_factor"], draws, trained_decoders(m), r["N_samples"], r["N_surface"],
        loss_scale=loss_scale)


def groups(grids, decoders, cams, cfg: dict, ba: bool) -> Dict[tuple, torch.Tensor]:
    """NICE-SLAM's optimiser groups: each grid level, the trained decoders
    of each level (one flat vector), the window cameras under bundle
    adjustment."""
    out = {("grids", k): v.detach() for k, v in grids.items()}
    for lvl in trained_decoders(cfg["mapping"]):
        out[("decoders", lvl)] = torch.cat([t.detach().reshape(-1) for _, t in
                                            R.leaves(decoders[lvl])])
    if ba:
        out[("cams",)] = cams.detach()
    return out
