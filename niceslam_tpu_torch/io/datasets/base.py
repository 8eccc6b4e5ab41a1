"""RGB-D frame record and reader protocol (host-side numpy).

Readers return OpenGL-style c2w poses (x right, y up, -z forward) as float32
``[4, 4]``; color in [0, 1] and metric depth (0 = invalid) as float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Protocol


@dataclass
class Frame:
    idx: int
    color: Any  # [H, W, 3] float32 in [0, 1] (numpy or torch)
    depth: Any  # [H, W] float32 meters (0 = invalid)
    gt_c2w: Optional[Any]  # [4, 4] float32 OpenGL c2w, or None


class FrameReader(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Frame: ...
