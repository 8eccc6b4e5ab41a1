"""RGB-D frame record, reader protocol and reader registry (host-side numpy).

Readers return OpenGL-style c2w poses (x right, y up, -z forward) as float32
``[4, 4]``; color in [0, 1] and metric depth (0 = invalid) as float32.
OpenCV-style sources are converted by negating the y and z basis columns.
:func:`get_dataset` builds the reader that ``cfg.dataset`` names, under the
JAX package's names: ``cofusion``, ``replica``, ``tumrgbd``, ``scannet``,
``apartment`` and ``synthetic``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Optional, Protocol

import numpy as np


@dataclass
class Frame:
    idx: int
    color: Any  # [H, W, 3] float32 in [0, 1] (numpy or torch)
    depth: Any  # [H, W] float32 meters (0 = invalid)
    gt_c2w: Optional[Any]  # [4, 4] float32 OpenGL c2w, or None


class FrameReader(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Frame: ...


def opencv_to_opengl(c2w: np.ndarray) -> np.ndarray:
    """Negate the y and z basis columns (upstream dataset convention)."""
    out = np.asarray(c2w, np.float32).copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def crop_frame(color, depth, crop_edge: int):
    if crop_edge > 0:
        color = color[crop_edge:-crop_edge, crop_edge:-crop_edge]
        depth = depth[crop_edge:-crop_edge, crop_edge:-crop_edge]
    return color, depth


def iterate(reader: FrameReader) -> Iterator[Frame]:
    for i in range(len(reader)):
        yield reader[i]


_REGISTRY = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_dataset(cfg) -> FrameReader:
    """Construct the reader named by ``cfg.dataset`` from an SLAMConfig."""
    from . import cofusion, replica, scannet, synthetic, tumrgbd  # noqa: F401 (register)

    if cfg.dataset not in _REGISTRY:
        raise KeyError(f"unknown dataset {cfg.dataset!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[cfg.dataset](cfg)
