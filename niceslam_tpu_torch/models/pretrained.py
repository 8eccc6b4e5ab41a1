"""Load the repo's pretrained decoders from the flat ``.npz`` format.

The file (``models/pretrained_decoders.npz``) holds one array per decoder
leaf under keys like ``middle/linears/0/w`` (weights stored ``[in, out]``),
81 keys for the four decoders. Loading is strict: every leaf of the model
must be present with the same shape.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten_with_keys(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_keys(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_keys(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, values, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)
        )
    return values[prefix[:-1]]


def load_decoders_npz(path: str, params):
    """Overlay a flat-npz decoder checkpoint onto ``params`` (strict keys);
    the loaded tensors keep each leaf's device and dtype."""
    blob = np.load(path)
    values = {}
    for key, leaf in _flatten_with_keys(params):
        if key not in blob:
            raise KeyError(f"pretrained npz missing decoder leaf {key!r}")
        arr = blob[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"decoder leaf {key!r}: checkpoint {arr.shape} vs model "
                f"{tuple(leaf.shape)}"
            )
        values[key] = torch.as_tensor(arr, dtype=leaf.dtype).to(leaf.device)
    return _rebuild(params, values)
