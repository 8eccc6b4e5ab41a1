"""Carry state across from the JAX package: nested numpy -> the port's tensors.

The JAX package's state, passed as nested dicts/lists of numpy arrays
(``jax.tree.map(np.asarray, ...)`` of its pytrees), maps one to one onto
this package's: grids ``{level: [Z, Y, X, C]}``, the decoder tree
(``{level: {"linears": [{"w", "b"}, ...], "fc_c": [...], "out": {...},
"embed_B": [3, 93]}}``, weights ``[in, out]``), per-level bounds and the
scene bound. The layouts are shared, so nothing is transposed. The tests use
these so that both packages compute on identical parameters.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def to_torch(tree, device="cuda"):
    """Nested dicts/lists of arrays -> the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.array(tree)  # a private, writable copy
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def grids_from_jax(grids: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    return {lvl: to_torch(g, device).contiguous() for lvl, g in grids.items()}


def decoders_from_jax(decoders: Dict, device="cuda") -> Dict:
    return to_torch(decoders, device)


def bounds_from_jax(
    bounds: Dict[str, np.ndarray], scene_bound: np.ndarray, device="cuda"
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    return to_torch(bounds, device), to_torch(scene_bound, device)

