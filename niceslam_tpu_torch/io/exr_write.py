"""Minimal OpenEXR scanline ENCODER (FLOAT channels, NONE/ZIP compression).

A copy of the JAX package's ``io/exr_write.py``: written from the public
OpenEXR file-format specification, it produces single-part scanline images
that the repository's native decoder (``native/exr.cpp``) and OpenCV read.
The port's smoke run and tests write their Co-Fusion depth fixtures with it.

ZIP block packing is the exact inverse of native/exr.cpp zip_reconstruct:
split bytes into even/odd halves, delta-encode (d[i] = b[i] - b[i-1] + 128),
deflate; blocks of 16 scanlines (compression id 3).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = struct.pack("<I", 20000630)
_VERSION = struct.pack("<I", 2)
_PT_FLOAT = 2


def _attr(name: str, typ: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + typ.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def _chlist(names) -> bytes:
    out = b""
    for n in sorted(names):  # EXR requires alphabetical channel order
        out += (
            n.encode() + b"\0"
            + struct.pack("<i", _PT_FLOAT)
            + struct.pack("<i", 0)      # pLinear + 3 reserved
            + struct.pack("<ii", 1, 1)  # x/y sampling
        )
    return out + b"\0"


def _zip_pack(raw: bytes) -> bytes:
    """Predictor + interleave + deflate (inverse of zip_reconstruct)."""
    b = np.frombuffer(raw, np.uint8)
    half = (len(b) + 1) // 2
    buf = np.empty_like(b)
    buf[:half] = b[0::2]
    buf[half:] = b[1::2]
    enc = buf.astype(np.int16)
    enc[1:] = enc[1:] - enc[:-1].astype(np.int16) + 128
    return zlib.compress(enc.astype(np.uint8).tobytes())


def write_exr(
    path: str,
    img: np.ndarray,
    channel_names=None,
    compression: str = "zip",
) -> None:
    """Write ``img`` ([H, W] or [H, W, C] float32) as a scanline EXR.

    Default channel naming: 'Y' for one channel, 'R','G','B'(,'A') beyond.
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = ["Y"] if C == 1 else ["R", "G", "B", "A"][:C]
    assert len(channel_names) == C
    order = np.argsort(channel_names)  # file stores channels alphabetically

    comp_id = {"none": 0, "zip": 3}[compression]
    lines_per_block = 16 if comp_id == 3 else 1

    header = (
        _attr("channels", "chlist", _chlist(channel_names))
        + _attr("compression", "compression", bytes([comp_id]))
        + _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
        + _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
        + _attr("lineOrder", "lineOrder", b"\0")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )

    n_blocks = -(-H // lines_per_block)
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        y1 = min(y0 + lines_per_block, H)
        # per scanline: every channel's full row, channels alphabetical
        rows = b"".join(
            img[y, :, order[c]].tobytes()
            for y in range(y0, y1)
            for c in range(C)
        )
        if comp_id == 3:
            packed = _zip_pack(rows)
            if len(packed) >= len(rows):
                packed = rows  # store-raw fallback (decoders accept it)
        else:
            packed = rows
        blocks.append((y0, packed))

    base = len(_MAGIC) + len(_VERSION) + len(header) + 8 * n_blocks
    offsets, pos = [], base
    for y0, packed in blocks:
        offsets.append(pos)
        pos += 8 + len(packed)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_VERSION)
        f.write(header)
        for off in offsets:
            f.write(struct.pack("<Q", off))
        for y0, packed in blocks:
            f.write(struct.pack("<ii", y0, len(packed)))
            f.write(packed)
