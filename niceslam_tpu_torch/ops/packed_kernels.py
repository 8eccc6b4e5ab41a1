"""The packed corner-table route's three CUDA kernels, their plain versions,
and the differentiable op that binds them.

- ``corner_table`` (K3) replaces the TPU kernel ``corner_table_pallas``
  (``niceslam_tpu/ops/pallas_trilerp.py:72-140``): the packed table
  ``[Z*Y*X, 8C]`` whose row ``(z, y, x)`` holds the voxel's 8 corners in
  ``[x][y][z]`` block order (block ``b = x1*4 + y1*2 + z1``), the +1
  neighbours edge-replicated.
- ``gather_rows`` (K4) replaces ``gather_rows_pallas``
  (``pallas_trilerp.py:144-176``): ``table[idx]``.
- ``scatter_corners`` (K5) replaces ``scatter_corners_pallas``
  (``pallas_trilerp.py:262-320``): corner cotangents ``ct8 [N, 8, C]`` in
  ``k = z1*4 + y1*2 + x1`` order scatter-added into the canonical grid at the
  four x-pair starts ``idx4 [N, 4]`` (rows ``r`` and ``r + 1``), on the card
  by a row-owner reduction in int64 fixed point (``csrc/fixed_sum.cuh``: the
  same bits whatever order the points come in; ``ops/fixed_point.py``
  models it).
- :class:`PackedRows` is ``(grid, start) -> rows [N, 8C]``: K3 then K4
  forward, K5 backward straight into the grid (no table gradient), a ``jvp``
  and a ``vmap`` rule, so ``torch.func.jacfwd`` goes through it.

Every compute function dispatches on the device of its tensors: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain PyTorch
version beside it. The kernels are built from ``csrc/packed_table.cu`` by the
same nvcc path as ``csrc/trilerp.cu`` (:func:`.trilerp_kernels.build`).
``LAUNCHES`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .trilerp_kernels import CSRC, _launch_check, load_library

LAUNCHES = {"corner_table": 0, "gather_rows": 0, "scatter_corners": 0}

SRC = CSRC / "packed_table.cu"
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB = load_library(SRC, {
            "corner_table": [p, p, i, i, i, i, p],
            "gather_rows": [p, p, p, i, i, i, p],
            "scatter_corners": [p, p, p, p, i, i, i, p],
            "scatter_corners_scratch": [i, i, i],
        })
    return _LIB


def _check_tensor(name, t, dtype, dim, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


# ------------------------------------------------------------ plain versions
def corner_table_plain(grid: torch.Tensor) -> torch.Tensor:
    """Plain K3: the shifted concats of ``ops/trilinear.corner_table``."""
    z1 = torch.cat([grid[1:], grid[-1:]], dim=0)
    d = torch.cat([grid, z1], dim=-1)  # [..., 2C]: (z0, z1)
    y1 = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
    d = torch.cat([d, y1], dim=-1)  # [..., 4C]: (y0, y1) x (z0, z1)
    x1 = torch.cat([d[:, :, 1:], d[:, :, -1:]], dim=2)
    d = torch.cat([d, x1], dim=-1)  # [..., 8C]
    return d.reshape(-1, d.shape[-1])


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K4: ``table[idx]``."""
    return table[idx.long()]


def scatter_corners_plain(
    idx4: torch.Tensor, ct8: torch.Tensor, r_rows: int
) -> torch.Tensor:
    """Plain K5: ``index_add_`` of the 4 row pairs into ``[r_rows, C]``."""
    C = ct8.shape[-1]
    rows = idx4.long()[:, :, None] + torch.arange(2, device=idx4.device)  # [N, 4, 2]
    return torch.zeros((r_rows, C), dtype=ct8.dtype, device=ct8.device).index_add_(
        0, rows.reshape(-1), ct8.reshape(-1, C)
    )


def corner_weights(wz, wy, wx) -> torch.Tensor:
    """``[N, 8]`` trilinear corner weights in ``k = z1*4 + y1*2 + x1`` order
    (``pallas_trilerp.corner_weights``)."""
    pz = torch.stack([1 - wz, wz], -1)  # [N, 2]
    py = torch.stack([1 - wy, wy], -1)
    px = torch.stack([1 - wx, wx], -1)
    return (
        pz[:, :, None, None] * py[:, None, :, None] * px[:, None, None, :]
    ).reshape(wz.shape[0], 8)


def pair_starts(start: torch.Tensor, Y: int, X: int) -> torch.Tensor:
    """x-pair starts ``idx4 [N, 4]`` (int32) of the start rows ``start
    [N]``: pair ``j = z1*2 + y1`` begins at row ``start + z1*Y*X + y1*X``.
    (Built from the offsets as Python numbers: a tensor of them made on the
    host would cost a copy to the card that waits for its stream.)"""
    return torch.stack(
        [start, start + X, start + Y * X, start + (Y * X + X)], dim=1
    ).contiguous()


# ----------------------------------------------------------- compute functions
def corner_table(grid: torch.Tensor) -> torch.Tensor:
    """K3: packed corner table ``[Z*Y*X, 8C]`` of ``grid [Z, Y, X, C]``."""
    _check_tensor("grid", grid, torch.float32, 4, grid.device)
    if grid.device.type == "cpu":
        return corner_table_plain(grid)
    Z, Y, X, C = grid.shape
    table = torch.empty((Z * Y * X, 8 * C), dtype=grid.dtype, device=grid.device)
    if table.numel() == 0:
        return table
    with torch.cuda.device(grid.device):
        rc = _lib().corner_table(
            grid.data_ptr(), table.data_ptr(), Z, Y, X, C,
            torch.cuda.current_stream().cuda_stream,
        )
    _launch_check(rc, "corner_table")
    LAUNCHES["corner_table"] += 1
    return table


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4: ``table [R, W]`` rows at int32 ``idx [N]`` -> ``[N, W]``."""
    _check_tensor("table", table, torch.float32, 2, table.device)
    _check_tensor("idx", idx, torch.int32, 1, table.device)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    R, W = table.shape
    N = idx.shape[0]
    out = torch.empty((N, W), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = _lib().gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, R, W,
            torch.cuda.current_stream().cuda_stream,
        )
    _launch_check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def scatter_corners(idx4: torch.Tensor, ct8: torch.Tensor, r_rows: int) -> torch.Tensor:
    """K5: ``ct8 [N, 8, C]`` scatter-added at the x-pair starts ``idx4
    [N, 4]`` (int32) into a zeroed ``[r_rows, C]``."""
    _check_tensor("ct8", ct8, torch.float32, 3, ct8.device)
    _check_tensor("idx4", idx4, torch.int32, 2, ct8.device)
    N, eight, C = ct8.shape
    if eight != 8 or tuple(idx4.shape) != (N, 4):
        raise ValueError(
            f"need ct8 [N, 8, C] and idx4 [N, 4], got {tuple(ct8.shape)}, "
            f"{tuple(idx4.shape)}"
        )
    if ct8.device.type == "cpu":
        return scatter_corners_plain(idx4, ct8, r_rows)
    if N == 0 or C == 0:
        return torch.zeros((r_rows, C), dtype=ct8.dtype, device=ct8.device)
    out = torch.empty((r_rows, C), dtype=ct8.dtype, device=ct8.device)
    with torch.cuda.device(ct8.device):
        lib = _lib()
        scratch = torch.empty(lib.scatter_corners_scratch(r_rows, N, C), dtype=torch.int32,
                              device=ct8.device)
        rc = lib.scatter_corners(
            idx4.data_ptr(), ct8.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            N, r_rows, C,
            torch.cuda.current_stream().cuda_stream,
        )
    _launch_check(rc, "scatter_corners")
    LAUNCHES["scatter_corners"] += 1
    return out


# -------------------------------------------------------- differentiable op
class PackedRows(torch.autograd.Function):
    """``packed_rows(grid [Z,Y,X,C], start [N]) -> [N, 8C]``: the corner-table
    row of every start voxel, differentiable in the grid.

    ``start`` holds int32 flat rows ``(z0*Y + y0)*X + x0`` of starts clipped
    to ``dim - 2`` on every axis, so a row never reads an edge-replicated
    slot of the table, and the row's gradient is exactly the scatter of its
    8 corner cotangents into the canonical grid (K5): no table gradient is
    ever formed (``pallas_trilerp.py:296-297``). ``backward`` serves
    ``torch.autograd``; ``jvp`` (a grid tangent gathers like the grid) and
    the ``vmap`` rule serve ``torch.func.jacfwd``."""

    @staticmethod
    def forward(grid, start):
        return gather_rows(corner_table(grid), start)

    @staticmethod
    def setup_context(ctx, inputs, output):
        grid, start = inputs
        ctx.shape = tuple(grid.shape)
        ctx.save_for_backward(start)
        ctx.save_for_forward(start)

    @staticmethod
    def backward(ctx, grows):
        (start,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        Z, Y, X, C = ctx.shape
        # Table order [x][y][z] -> k order [z][y][x]; x-adjacent k form pairs.
        ct8 = (
            grows.reshape(-1, 2, 2, 2, C).permute(0, 3, 2, 1, 4).reshape(-1, 8, C)
        ).contiguous()
        dgrid = scatter_corners(pair_starts(start, Y, X), ct8, Z * Y * X)
        return dgrid.reshape(Z, Y, X, C), None

    @staticmethod
    def jvp(ctx, grid_dot, start_dot):
        (start,) = ctx.saved_tensors
        if grid_dot is None:
            Z, Y, X, C = ctx.shape
            return torch.zeros(
                (start.shape[0], 8 * C), dtype=torch.float32, device=start.device
            )
        return PackedRows.apply(grid_dot.contiguous(), start)

    @staticmethod
    def vmap(info, in_dims, grid, start):
        gdim, sdim = in_dims
        B = info.batch_size
        if sdim is None:
            # A batched grid folds into the channels: the table of
            # [Z, Y, X, B*C] has blocks [x][y][z][B*C], so its rows unfold
            # as [N, 8, B, C], not [N, B, 8C].
            g = grid.movedim(gdim, 3)
            Z, Y, X, _, C = g.shape
            rows = PackedRows.apply(g.reshape(Z, Y, X, B * C).contiguous(), start)
            N = rows.shape[0]
            return rows.reshape(N, 8, B, C).permute(2, 0, 1, 3).reshape(B, N, 8 * C), 0
        if gdim is None:
            s = start.movedim(sdim, 0)
            rows = PackedRows.apply(grid, s.reshape(-1).contiguous())
            return rows.reshape(B, s.shape[1], -1), 0
        outs = [
            PackedRows.apply(
                grid.select(gdim, b).contiguous(), start.select(sdim, b).contiguous()
            )
            for b in range(B)
        ]
        return torch.stack(outs), 0


def packed_rows(grid: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Differentiable corner-table rows ``[N, 8C]`` at int32 starts ``start``."""
    return PackedRows.apply(grid, start)
