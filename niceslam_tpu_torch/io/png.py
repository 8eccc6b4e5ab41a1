"""PNG reading and writing without OpenCV.

The JAX package reads and writes PNG with ``cv2``; the port does not need
OpenCV for PNG. This module does what the readers and the visualizer need:

- :func:`read_png_rgb` is ``cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]``:
  uint8 ``[H, W, 3]`` RGB from colour types 0, 2, 3, 4 and 6 (grey
  replicated, palette expanded, alpha dropped, 16-bit samples cut to their
  high byte);
- :func:`read_png_grey` is ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` on a
  grey file: ``[H, W]`` uint8 or uint16 from colour types 0 and 4;
- :func:`write_png` writes uint8 RGB ``[H, W, 3]`` or uint16 grey
  ``[H, W]`` with filter type 0 and ``zlib.compress``.

Reading takes non-interlaced files of bit depth 8 or 16 and raises
``IOError`` naming the file and the reason for anything else. The IDAT
stream is inflated by ``zlib`` and the rows are unfiltered by
``native/png_unfilter.cpp``, built at first use (``io/native_build.py``);
both release the interpreter lock, so the prefetcher's decoding does not
stall the loop that launches the kernels. :func:`unfilter_plain` is the same
function in Python, for the tests.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from . import native_build

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_SRC = Path(__file__).resolve().parent.parent / "native" / "png_unfilter.cpp"


def _lib():
    i64, p = ctypes.c_int64, ctypes.c_void_p
    return native_build.load(
        "png_unfilter", [_SRC], {"png_unfilter": (ctypes.c_int, [p, p, i64, i64, i64])}
    )


def unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Unfiltered rows ``[rows, stride]`` uint8 from the inflated IDAT data
    (``rows`` lines of a filter byte and ``stride`` bytes), in C++."""
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((rows, stride), np.uint8)
    rc = _lib().png_unfilter(src.ctypes.data, out.ctypes.data, rows, stride, bpp)
    if rc != 0:
        raise ValueError(f"row {rc - 1}: unknown filter type {src[(rc - 1) * (stride + 1)]}")
    return out


def unfilter_plain(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """:func:`unfilter` in plain Python (slow: for the tests)."""
    src = np.frombuffer(raw, np.uint8).reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(rows):
        ftype, line = int(src[y, 0]), src[y, 1:].astype(np.int64)
        cur = np.zeros(stride, np.int64)
        if ftype == 0:
            cur[:] = line
        elif ftype == 2:
            cur[:] = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _decode(path: str):
    """``(samples [H, W, channels] uint8 or uint16, colour type, palette)``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise IOError(f"{path}: not a PNG file (bad signature)")
    mv = memoryview(data)
    pos, ihdr, plte, idat = 8, None, None, []
    while True:
        if pos + 12 > len(data):
            raise IOError(f"{path}: truncated PNG (no IEND chunk)")
        (n,) = struct.unpack(">I", mv[pos:pos + 4])
        ctype = bytes(mv[pos + 4:pos + 8])
        body = mv[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise IOError(f"{path}: truncated PNG ({ctype!r} chunk)")
        (crc,) = struct.unpack(">I", mv[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body, zlib.crc32(ctype)) != crc:
            raise IOError(f"{path}: CRC mismatch in the {ctype.decode(errors='replace')} chunk")
        pos += 12 + n
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise IOError(f"{path}: PNG without an IHDR or IDAT chunk")
    W, H, depth, color_type, comp, filt, interlace = ihdr
    if interlace != 0:
        raise IOError(f"{path}: interlaced PNG is not supported")
    if color_type not in _CHANNELS:
        raise IOError(f"{path}: PNG colour type {color_type} is not supported")
    if depth not in (8, 16) or (color_type == 3 and depth != 8):
        raise IOError(f"{path}: PNG bit depth {depth} (colour type {color_type}) "
                      "is not supported")
    if comp != 0 or filt != 0:
        raise IOError(f"{path}: unknown PNG compression {comp} or filter method {filt}")
    if color_type == 3 and plte is None:
        raise IOError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[color_type]
    bpp = ch * depth // 8
    stride = W * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"{path}: corrupt IDAT stream ({e})") from None
    if len(raw) != H * (stride + 1):
        raise IOError(f"{path}: IDAT holds {len(raw)} bytes, want {H * (stride + 1)}")
    try:
        rows = unfilter(raw, H, stride, bpp)
    except ValueError as e:
        raise IOError(f"{path}: {e}") from None
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(H, W, ch)
    else:
        samples = rows.reshape(H, W, ch)
    return samples, color_type, plte


def read_png_rgb(path: str) -> np.ndarray:
    """uint8 ``[H, W, 3]`` RGB, as ``cv2.imread(path, IMREAD_COLOR)`` in RGB order."""
    s, color_type, plte = _decode(path)
    if color_type == 3:
        idx = s[..., 0]
        if int(idx.max()) >= len(plte):
            raise IOError(f"{path}: palette index beyond the {len(plte)}-entry PLTE")
        return plte[idx]
    if s.dtype == np.uint16:
        s = (s >> 8).astype(np.uint8)
    if color_type in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def read_png_grey(path: str) -> np.ndarray:
    """``[H, W]`` uint8 or uint16 of a grey PNG, as
    ``cv2.imread(path, IMREAD_ANYDEPTH)``; raises on a colour file."""
    s, color_type, _ = _decode(path)
    if color_type not in (0, 4):
        raise IOError(f"{path}: a colour PNG (type {color_type}) where a grey one is read")
    return np.ascontiguousarray(s[..., 0])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 ``[H, W, 3]`` RGB or uint16 ``[H, W]`` grey as a PNG with
    filter type 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color_type, depth, data = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color_type, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes uint8 [H, W, 3] or uint16 [H, W], "
                         f"not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rows = np.zeros((H, 1 + data[0].nbytes), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(data).view(np.uint8).reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))
