"""The trilinear sampler's two CUDA kernels, their plain versions, and the
differentiable op that binds them.

- ``trilerp_fwd`` (K1) replaces the TPU kernel ``trilerp_vmem``
  (``niceslam_tpu/ops/pallas_trilerp.py:180-258``); with ``deriv=True`` it
  also returns the spatial derivative ``dV/dv [N, 3, C]``. A group of
  lanes reads each point's corners, one float4 per corner per lane where
  :func:`fwd_variant` allows it.
- ``trilerp_bwd`` (K2) replaces ``trilerp_bwd_pallas``
  (``pallas_trilerp.py:334-438``): ``dgrid`` by a row-owner reduction in
  int64 fixed point (``csrc/fixed_sum.cuh``: the same bits whatever order
  the points come in; ``ops/fixed_point.py`` models it) and ``dv`` by warp
  reductions.
- :class:`TrilerpFunction` replaces the ``trilerp_pallas`` custom_vjp
  (``pallas_trilerp.py:460-485``) and adds what JAX's custom_vjp could not
  give: a forward-mode ``jvp`` and a ``vmap`` rule, so ``torch.func.jacfwd``
  differentiates through the sampler (the Gauss-Newton tracker's Jacobian).

Every compute function dispatches on the device of its tensors: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain PyTorch
version beside it. Nothing falls back from one to the other.

The kernels are built from ``csrc/trilerp.cu`` with ``nvcc`` at first use
into ``<repo>/build/kernels/`` (one shared library per source digest) and
bound with ``ctypes``. :func:`build` and :func:`load_library` serve every
``csrc/*.cu`` of the package (and the ``csrc/*.cuh`` they include).
``LAUNCHES`` counts each kernel's launches; ``FWD_TALLY`` splits K1's by
the variant launched, derivative output and number of points, and
``BWD_TALLY`` K2's by which of the grid and point gradients were asked for.
``COUNTERS`` names the three. A replay of a captured CUDA graph runs no
Python: :func:`read_counts` and :func:`add_counts` carry the launches that
a graph's capture recorded over to each of its replays
(``slam/programs.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

LAUNCHES = {"trilerp_fwd": 0, "trilerp_bwd": 0}
# K1's launches by (variant, deriv, N); their sum is LAUNCHES["trilerp_fwd"].
FWD_TALLY: Counter = Counter()
# K2's launches by (need_dgrid, need_dv): (False, True) is the per-point dv
# pass alone (the grid is not differentiated), (True, False) the grid
# gradient alone (the points are constants); their sum is
# LAUNCHES["trilerp_bwd"].
BWD_TALLY: Counter = Counter()
COUNTERS = {"LAUNCHES": LAUNCHES, "FWD_TALLY": FWD_TALLY, "BWD_TALLY": BWD_TALLY}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = CSRC / "trilerp.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FWD_TALLY.clear()
    BWD_TALLY.clear()


def read_counts(counters) -> Dict[str, Counter]:
    """A reading of the launch counters ``counters`` (a ``COUNTERS``):
    ``{name: Counter}``. The difference of two readings is what the code
    between them launched."""
    return {name: Counter(table) for name, table in counters.items()}


def add_counts(counters, delta: Dict[str, Counter], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two :func:`read_counts`)
    to ``counters``."""
    for name, counts in delta.items():
        table = counters[name]
        for key, n in counts.items():
            table[key] = table.get(key, 0) + n * times


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def build(src: Path = _SRC, verbose: bool = False) -> Tuple[Path, str]:
    """Compile the CUDA source ``src`` into ``build/kernels`` if not built yet.

    Returns ``(library path, compiler output)``. ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel). Raises
    when nvcc is missing or fails.
    """
    src = Path(src)
    headers = sorted(src.parent.glob("*.cuh"))
    digest = hashlib.sha1(
        b"".join(f.read_bytes() for f in [src, *headers])
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load_library(src: Path, signatures) -> ctypes.CDLL:
    """Build ``src`` and bind it: ``signatures`` maps each C entry point to
    its argument types, as ``ctypes.c_void_p`` (pointers, streams) and
    ``ctypes.c_int``; every entry point returns an ``int`` error code."""
    path, _ = build(src)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB = load_library(_SRC, {
            "trilerp_fwd": [p, p, p, p, i, i, i, i, i, i, i, p],
            "trilerp_bwd": [p, p, p, p, p, p, i, i, i, i, i, p],
            "trilerp_bwd_scratch": [i, i, i],
        })
    return _LIB


def _check(grid: torch.Tensor, v: torch.Tensor, g: Optional[torch.Tensor] = None):
    if grid.dim() != 4:
        raise ValueError(f"grid must be [Z, Y, X, C], got {tuple(grid.shape)}")
    if min(grid.shape[:3]) < 2:
        raise ValueError(f"every grid axis needs >= 2 voxels: {tuple(grid.shape)}")
    if v.dim() != 2 or v.shape[1] != 3:
        raise ValueError(f"coordinates must be [N, 3], got {tuple(v.shape)}")
    ts = [("grid", grid), ("v", v)] + ([("g", g)] if g is not None else [])
    for name, t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != grid.device:
            raise ValueError(f"{name} on {t.device}, grid on {grid.device}")
    if g is not None and tuple(g.shape) != (v.shape[0], grid.shape[3]):
        raise ValueError(f"g must be [N, C], got {tuple(g.shape)}")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {grid.device}")


def fwd_variant(C: int, grid_ptr: int, out_ptr: int, dout_ptr: Optional[int] = None):
    """K1's variant and lanes per point for these addresses and C, as
    ``("vector" | "scalar", G)``: the one place of the rule, whose choice
    :func:`trilerp_fwd` passes to the kernel's entry point (which refuses
    a vector variant that the pointers do not fit). The vector variant (one
    float4 per corner per lane) needs C % 4 == 0 and grid, out and dout
    16-byte aligned; G is the largest power of two up to the units per row
    (4 channels or 1) and up to 8 (vector) or 32 (scalar)."""
    ptrs = (grid_ptr, out_ptr) + (() if dout_ptr is None else (dout_ptr,))
    vec = C % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    units = C // 4 if vec else C
    g = 1
    while 2 * g <= min(8 if vec else 32, units):
        g *= 2
    return ("vector" if vec else "scalar"), g


def _launch_check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# ------------------------------------------------------------ plain versions
_CORNERS = tuple((dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))


def _corner_rows(shape3, v: torch.Tensor):
    """Corner rows ``[N, 8]`` (k = z1*4 + y1*2 + x1) and weights ``[N, 3]``."""
    Z, Y, X = shape3
    hi = torch.tensor([Z - 2, Y - 2, X - 2], device=v.device)
    start = torch.minimum(torch.clamp(torch.floor(v).long(), min=0), hi)
    w = v - start.to(v.dtype)
    r000 = (start[:, 0] * Y + start[:, 1]) * X + start[:, 2]
    offs = torch.tensor(
        [(dz * Y + dy) * X + dx for dz, dy, dx in _CORNERS], device=v.device
    )
    return r000[:, None] + offs, w


def corner_terms(shape3, v: torch.Tensor, g: torch.Tensor):
    """K2's scatter: corner rows ``[N, 8]`` of voxel coords ``v`` and their
    terms ``[N*8, C]``, ``pz * py * px * g`` in that order of products."""
    rows, w = _corner_rows(shape3, v)
    pz = torch.stack([1 - w[:, 0], w[:, 0]], -1)
    py = torch.stack([1 - w[:, 1], w[:, 1]], -1)
    px = torch.stack([1 - w[:, 2], w[:, 2]], -1)
    w8 = (pz[:, :, None, None] * py[:, None, :, None] * px[:, None, None, :]).reshape(-1, 8)
    return rows, (w8[:, :, None] * g[:, None, :]).reshape(-1, g.shape[-1])


def _lerp_parts(grid: torch.Tensor, v: torch.Tensor):
    rows, w = _corner_rows(grid.shape[:3], v)
    c = grid.reshape(-1, grid.shape[-1])[rows]  # [N, 8, C]
    wz, wy, wx = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    c00 = c[:, 0] * (1 - wx) + c[:, 1] * wx
    c01 = c[:, 2] * (1 - wx) + c[:, 3] * wx
    c10 = c[:, 4] * (1 - wx) + c[:, 5] * wx
    c11 = c[:, 6] * (1 - wx) + c[:, 7] * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c, (wz, wy, wx), (c00, c01, c10, c11, c0, c1), rows


def trilerp_fwd_plain(grid: torch.Tensor, v: torch.Tensor, deriv: bool = False):
    """Plain PyTorch K1: ``(out [N, C], dV/dv [N, 3, C] or None)``."""
    c, (wz, wy, wx), (c00, c01, c10, c11, c0, c1), _ = _lerp_parts(grid, v)
    out = c0 * (1 - wz) + c1 * wz
    if not deriv:
        return out, None
    dz = c1 - c0
    dy = (c01 - c00) * (1 - wz) + (c11 - c10) * wz
    dx0 = (c[:, 1] - c[:, 0]) * (1 - wy) + (c[:, 3] - c[:, 2]) * wy
    dx1 = (c[:, 5] - c[:, 4]) * (1 - wy) + (c[:, 7] - c[:, 6]) * wy
    dx = dx0 * (1 - wz) + dx1 * wz
    return out, torch.stack([dz, dy, dx], dim=1)


def trilerp_bwd_plain(
    grid: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    need_dgrid: bool = True, need_dv: bool = True,
):
    """Plain PyTorch K2: ``(dgrid [Z,Y,X,C] or None, dv [N, 3] or None)``."""
    dgrid = dv = None
    if need_dgrid:
        rows, ct = corner_terms(grid.shape[:3], v, g)
        C = grid.shape[-1]
        dgrid = torch.zeros(
            (grid[..., 0].numel(), C), dtype=grid.dtype, device=grid.device
        ).index_add_(0, rows.reshape(-1), ct).reshape(grid.shape)
    if need_dv:
        _, dvol = trilerp_fwd_plain(grid, v, deriv=True)
        dv = torch.sum(dvol * g[:, None, :], dim=-1)
    return dgrid, dv


# ----------------------------------------------------------- compute functions
def trilerp_fwd(grid: torch.Tensor, v: torch.Tensor, deriv: bool = False):
    """K1: ``(out [N, C], dV/dv [N, 3, C] or None)`` at voxel coords ``v``."""
    _check(grid, v)
    if grid.device.type == "cpu":
        return trilerp_fwd_plain(grid, v, deriv)
    Z, Y, X, C = grid.shape
    N = v.shape[0]
    if Z * Y * X >= 2**31:
        raise ValueError(f"K1 takes grids of fewer than 2^31 rows: {tuple(grid.shape)}")
    out = torch.empty((N, C), dtype=grid.dtype, device=grid.device)
    dout = (
        torch.empty((N, 3, C), dtype=grid.dtype, device=grid.device)
        if deriv else None
    )
    if N == 0:
        return out, dout
    dptr = dout.data_ptr() if deriv else None
    variant, G = fwd_variant(C, grid.data_ptr(), out.data_ptr(), dptr)
    with torch.cuda.device(grid.device):
        rc = _lib().trilerp_fwd(
            grid.data_ptr(), v.data_ptr(), out.data_ptr(), dptr, N, Z, Y, X, C,
            variant == "vector", G, torch.cuda.current_stream().cuda_stream,
        )
    _launch_check(rc, "trilerp_fwd")
    LAUNCHES["trilerp_fwd"] += 1
    FWD_TALLY[variant, deriv, N] += 1
    return out, dout


def trilerp_bwd(
    grid: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    need_dgrid: bool = True, need_dv: bool = True,
):
    """K2: ``(dgrid [Z,Y,X,C] or None, dv [N, 3] or None)`` for cotangent ``g``."""
    _check(grid, v, g)
    if grid.device.type == "cpu":
        return trilerp_bwd_plain(grid, v, g, need_dgrid, need_dv)
    Z, Y, X, C = grid.shape
    N = v.shape[0]
    if N == 0:
        return (torch.zeros_like(grid) if need_dgrid else None,
                v.new_empty((0, 3)) if need_dv else None)
    dgrid = torch.empty_like(grid) if need_dgrid else None
    dv = torch.empty((N, 3), dtype=v.dtype, device=v.device) if need_dv else None
    if not (need_dgrid or need_dv):
        return dgrid, dv
    with torch.cuda.device(grid.device):
        lib = _lib()
        scratch = (
            torch.empty(lib.trilerp_bwd_scratch(Z * Y * X, N, C), dtype=torch.int32,
                        device=grid.device)
            if need_dgrid else None
        )
        rc = lib.trilerp_bwd(
            grid.data_ptr(), v.data_ptr(), g.data_ptr(),
            scratch.data_ptr() if need_dgrid else None,
            dgrid.data_ptr() if need_dgrid else None,
            dv.data_ptr() if need_dv else None, N, Z, Y, X, C,
            torch.cuda.current_stream().cuda_stream,
        )
    _launch_check(rc, "trilerp_bwd")
    LAUNCHES["trilerp_bwd"] += 1
    BWD_TALLY[need_dgrid, need_dv] += 1
    return dgrid, dv


# -------------------------------------------------------- differentiable op
class TrilerpFunction(torch.autograd.Function):
    """``trilerp(grid [Z,Y,X,C], v [N,3]) -> [N, C]``, differentiable in both
    arguments: ``backward`` -> K2, ``jvp`` -> K1 with its derivative output
    (plus ``trilerp(grid_dot, v)`` when the grid has a tangent), and an
    explicit ``vmap`` rule that folds a batched grid into channels or a
    batched ``v`` into points. ``backward`` serves ``torch.autograd``; the
    reverse-mode ``torch.func`` transforms (``grad``, ``vjp``, ``jacrev``)
    would hand K2 wrapper tensors and are not supported on CUDA."""

    @staticmethod
    def forward(grid, v):
        return trilerp_fwd(grid, v)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        grid, v = inputs
        ctx.save_for_backward(grid, v)
        ctx.save_for_forward(grid, v)

    @staticmethod
    def backward(ctx, gout):
        grid, v = ctx.saved_tensors
        need_grid, need_v = ctx.needs_input_grad[:2]
        return trilerp_bwd(grid, v, gout.contiguous(), need_grid, need_v)

    @staticmethod
    def jvp(ctx, grid_dot, v_dot):
        # Under torch.func the saved tensors are transform wrappers without
        # storage, so the derivative goes through a Function of its own,
        # which hands its forward (and so the kernel) the plain tensors.
        grid, v = ctx.saved_tensors
        out_dot = None
        if v_dot is not None:
            dvol = _TrilerpDeriv.apply(grid, v)  # [N, 3, C]
            out_dot = torch.sum(dvol * v_dot[..., None], dim=-2)
        if grid_dot is not None:
            gd = TrilerpFunction.apply(grid_dot.contiguous(), v)
            out_dot = gd if out_dot is None else out_dot + gd
        if out_dot is None:
            out_dot = grid.new_zeros((v.shape[0], grid.shape[-1]))
        return out_dot

    @staticmethod
    def vmap(info, in_dims, grid, v):
        return _vmap_rule(TrilerpFunction.apply, info, in_dims, grid, v)


class _TrilerpDeriv(torch.autograd.Function):
    """``dV/dv [N, 3, C]`` (K1 with its derivative output) as an op that
    ``torch.func`` transforms can call from :meth:`TrilerpFunction.jvp`.
    It is not differentiable itself: the sampler has no second derivative."""

    @staticmethod
    def forward(grid, v):
        return trilerp_fwd(grid, v, deriv=True)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("the sampler has no second derivative")

    @staticmethod
    def jvp(ctx, grid_dot, v_dot):
        raise NotImplementedError("the sampler has no second derivative")

    @staticmethod
    def vmap(info, in_dims, grid, v):
        return _vmap_rule(_TrilerpDeriv.apply, info, in_dims, grid, v)


def _vmap_rule(apply, info, in_dims, grid, v):
    """Batch rule shared by the sampler's Functions, whose outputs are
    ``[N, ..., C]``: a batched grid folds into the channels, batched
    coordinates into the points; both batched loops over the batch."""
    gdim, vdim = in_dims
    B = info.batch_size
    C = grid.shape[-1]
    if vdim is None:
        g = grid.movedim(gdim, 3)
        Z, Y, X = g.shape[:3]
        out = apply(g.reshape(Z, Y, X, B * C).contiguous(), v)
        return out.reshape(*out.shape[:-1], B, C), out.dim() - 1
    if gdim is None:
        vv = v.movedim(vdim, 0).reshape(-1, 3).contiguous()
        out = apply(grid, vv)
        return out.reshape(B, -1, *out.shape[1:]), 0
    outs = [
        apply(grid.select(gdim, b).contiguous(), v.select(vdim, b).contiguous())
        for b in range(B)
    ]
    return torch.stack(outs), 0


def trilerp(grid: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable trilinear sample of ``grid`` at voxel coords ``v``."""
    return TrilerpFunction.apply(grid, v)
