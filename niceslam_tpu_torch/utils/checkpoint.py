"""Checkpoint / resume: ``torch.save`` of the SLAM state.

The payload has the JAX package's keys (``niceslam_tpu/utils/checkpoint.py``):
``grids``, ``decoders``, ``keyframes`` (with ``count``), ``version``,
``est_c2w``, ``gt_c2w`` (NaN where a frame has no ground truth),
``frame_idx``, ``bounds`` and ``scene_bound``. The grids are saved as the
system holds them: Z-padded for the map axis when a multi-rank runtime is
attached (``parallel/runtime.py``), with the extended bounds that go with
the padding, so a snapshot written at one ``parallel.map`` restores at
another (``NiceSLAM.restore`` pads it again when attached), as in the JAX
package. Everything in it is a tensor,
a number or a container of them, so :func:`load_checkpoint` reads it with
``weights_only=True``. The generator states are not saved, as in the JAX
package: a resumed run draws other pixels than an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..slam.state import KeyframeDB, MapState


def _poses(poses) -> torch.Tensor:
    """A pose list (numpy arrays or tensors on any device) as ``[n, 4, 4]``
    float32 on the CPU."""
    if not len(poses):
        return torch.zeros((0, 4, 4))
    return torch.stack([torch.as_tensor(p, dtype=torch.float32).cpu() for p in poses])


def save_checkpoint(
    path: str,
    state: MapState,
    est_c2w,
    gt_c2w,
    frame_idx: int,
    bounds: Optional[Dict[str, torch.Tensor]] = None,
    scene_bound: Optional[torch.Tensor] = None,
):
    """Write the snapshot to the file ``path`` (through a temporary file in
    the same directory, renamed when complete)."""
    db = state.keyframes
    payload = {
        "grids": state.grids,
        "decoders": state.decoders,
        "keyframes": {f.name: getattr(db, f.name) for f in dataclasses.fields(db)},
        "version": int(state.version),
        "est_c2w": _poses(est_c2w),
        "gt_c2w": _poses([np.full((4, 4), np.nan) if g is None else g for g in gt_c2w]),
        "frame_idx": int(frame_idx),
    }
    if bounds is not None:
        payload["bounds"] = bounds
    if scene_bound is not None:
        payload["scene_bound"] = scene_bound
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda") -> Dict[str, Any]:
    """Read a snapshot with its tensors on ``device``: ``state`` (a
    ``MapState``), ``est_c2w`` and ``gt_c2w`` (lists of numpy ``[4, 4]``,
    ``None`` where the ground truth was missing), ``frame_idx``, ``bounds``
    and ``scene_bound`` (``None`` where the snapshot has none)."""
    payload = torch.load(path, map_location=device, weights_only=True)
    state = MapState(
        grids=payload["grids"],
        decoders=payload["decoders"],
        keyframes=KeyframeDB(**payload["keyframes"]),
        version=payload["version"],
    )
    gts = payload["gt_c2w"].cpu().numpy()
    return {
        "state": state,
        "est_c2w": list(payload["est_c2w"].cpu().numpy()),
        "gt_c2w": [None if np.isnan(g).any() else g for g in gts],
        "frame_idx": payload["frame_idx"],
        "bounds": payload.get("bounds"),
        "scene_bound": payload.get("scene_bound"),
    }
