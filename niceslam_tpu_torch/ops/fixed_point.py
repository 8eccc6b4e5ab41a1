"""A plain PyTorch model of the grid-gradient sums of K2 (``trilerp_bwd``)
and K5 (``scatter_corners``) on the card, bit for bit, and of the row-owner
enumeration their kernels walk (``csrc/fixed_sum.cuh``).

The kernels quantize every term ``t`` to ``llrint(t * 2^e)`` (round half to
even), add the int64 numbers, and write ``float(sum * 2^-e)``, or NaN
everywhere when a value is not finite. ``e = 62 - k`` where
``terms * bound < 2^k``: ``bound`` is the largest ``|value|`` (float32) and
``terms = 8N``, so no sum leaves the int64 range. Integer sums do not depend
on order, so :func:`fixed_point_scatter_plain`, an int64 ``index_add_``,
gives the kernels' bits, and so does a permutation of the points.

The kernels sum each grid row by its owners, which walk the buckets that
feed it: :func:`trilerp_row_sources` (K2) and :func:`pair_row_sources` (K5)
say which, and :func:`row_owner_sum_plain` walks them as the kernels do
(count, exclusive scan, fill, then row by row).

Only the tests and ``chip_smoke.py`` use this module; the sampler's plain
versions (``trilerp_bwd_plain``, ``scatter_corners_plain``) sum in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .trilerp_kernels import corner_terms


def fixed_point_scale(bound: float, n_terms: int) -> float:
    """``2^(62 - k)`` with ``n_terms * bound < 2^k`` (``frexp`` of the
    product in double), as ``fixed_sum::scale_of``; 1 for a zero bound."""
    m = float(bound)
    if not m > 0.0:
        return 1.0
    _, k = math.frexp(m * float(n_terms))
    return math.ldexp(1.0, 62 - k)


def fixed_point_scatter_plain(
    rows: torch.Tensor, terms: torch.Tensor, r_rows: int, n_terms: int,
    bound: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernels' sum of ``terms [T, C]`` (float32) into rows ``rows [T]``
    of a ``[r_rows, C]`` grid. ``bound`` is the float32 bound the kernel
    takes (default: ``max |terms|``); ``n_terms`` the term count it scales
    for (8 per point). NaN everywhere if the bound or a term is not
    finite."""
    C = terms.shape[-1]
    if bound is None:
        bound = terms.abs().max() if terms.numel() else terms.new_zeros(())
    m = float(bound)
    if not math.isfinite(m) or not bool(torch.isfinite(terms).all()):
        return torch.full((r_rows, C), float("nan"), dtype=terms.dtype, device=terms.device)
    scale = fixed_point_scale(m, n_terms)
    q = torch.round(terms.double() * scale).long()  # half to even
    acc = torch.zeros((r_rows, C), dtype=torch.int64, device=terms.device)
    acc.index_add_(0, rows.long(), q)
    return (acc.double() * (1.0 / scale)).to(terms.dtype)


def trilerp_bwd_fixed_point(grid: torch.Tensor, v: torch.Tensor, g: torch.Tensor):
    """K2's ``dgrid [Z, Y, X, C]`` on the card, bit for bit."""
    rows, terms = corner_terms(grid.shape[:3], v, g)
    R = grid[..., 0].numel()
    return fixed_point_scatter_plain(
        rows.reshape(-1), terms, R, 8 * v.shape[0]).reshape(grid.shape)


def pair_terms(idx4: torch.Tensor, ct8: torch.Tensor, r_rows: int):
    """K5's scatter: the rows ``[T]`` and terms ``[T, C]`` of the x-pairs
    whose start ``idx4 [N, 4]`` lies in ``[0, r_rows - 2]`` (the kernel
    skips the others): pair ``j`` adds ``ct8[n, 2j + x1]`` to row
    ``idx4[n, j] + x1``."""
    C = ct8.shape[-1]
    s = idx4.long()
    rows = (s[:, :, None] + torch.arange(2, device=s.device)).reshape(-1)
    keep = ((s >= 0) & (s <= r_rows - 2))[:, :, None].expand(-1, -1, 2).reshape(-1)
    return rows[keep], ct8.reshape(-1, C)[keep]


def scatter_corners_fixed_point(idx4: torch.Tensor, ct8: torch.Tensor, r_rows: int):
    """K5's output ``[r_rows, C]`` on the card, bit for bit: its bound is
    taken over all of ``ct8``, skipped pairs included."""
    rows, terms = pair_terms(idx4, ct8, r_rows)
    bound = ct8.abs().max() if ct8.numel() else ct8.new_zeros(())
    return fixed_point_scatter_plain(rows, terms, r_rows, 8 * ct8.shape[0], bound)


# --------------------------------------------------- the row owners' walk
def trilerp_row_sources(rows: torch.Tensor, shape3):
    """The buckets that feed grid rows ``rows [M]`` in K2's row-owner sum:
    source ``k = z1*4 + y1*2 + x1`` of row ``r = (z, y, x)`` is the bucket
    of start ``r - (z1*Y*X + y1*X + x1)``, whose points add their corner
    ``k`` to ``r``; it exists where ``z >= z1, y >= y1, x >= x1``. Returns
    the buckets ``[M, 8]`` and that mask."""
    Z, Y, X = shape3
    r = rows.long()[:, None]
    x, y, z = r % X, (r // X) % Y, r // (X * Y)
    k = torch.arange(8, device=r.device)
    z1, y1, x1 = k >> 2, (k >> 1) & 1, k & 1
    return r - (z1 * (Y * X) + y1 * X + x1), (z >= z1) & (y >= y1) & (x >= x1)


def pair_row_sources(rows: torch.Tensor, r_rows: int):
    """The buckets that feed grid rows ``rows [M]`` in K5's row-owner sum:
    source ``s`` is bucket ``r - s``, whose pairs add their ``x1 = s`` row
    (``ct8[n, 2j + s]``) to ``r``; it exists where it is a pair start the
    kernel keeps, ``0 <= r - s <= r_rows - 2``. Returns ``[M, 2]`` and the
    mask."""
    b = rows.long()[:, None] - torch.arange(2, device=rows.device)
    return b, (b >= 0) & (b <= r_rows - 2)


def row_owner_sum_plain(
    keys: torch.Tensor, terms: torch.Tensor, sources: torch.Tensor,
    valid: torch.Tensor, n_buckets: int,
) -> torch.Tensor:
    """The row owners' walk: entry ``e`` lies in bucket ``keys[e]`` (in
    ``[0, n_buckets)``) and carries ``terms[e, s]`` (``[E, S, C]``) for
    source slot ``s``; row ``i`` sums, over its valid slots ``s``, the
    slot-``s`` terms of the entries in bucket ``sources[i, s]``. Buckets
    come from a count and an exclusive scan, the entries from a fill, and
    each row lists its entries in (slot, entry) order, as
    ``fixed_sum::row_sum_kernel`` does. Returns ``[M, C]``."""
    M, S = sources.shape
    keys = keys.long()
    counts = torch.bincount(keys, minlength=n_buckets)
    E = torch.zeros(n_buckets + 1, dtype=torch.long, device=keys.device)
    E[1:] = torch.cumsum(counts, 0)
    ids = torch.argsort(keys, stable=True)  # the fill: entries by bucket
    b = sources.clamp(0, n_buckets - 1)
    start = torch.where(valid, E[b], 0).reshape(-1)
    cnt = torch.where(valid, E[b + 1] - E[b], 0).reshape(-1)
    src = torch.repeat_interleave(torch.arange(M * S, device=keys.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt  # entries listed before each source
    pos = torch.arange(src.numel(), device=keys.device) - first[src] + start[src]
    e = ids[pos]
    out = torch.zeros((M, terms.shape[-1]), dtype=terms.dtype, device=terms.device)
    return out.index_add_(0, src // S, terms[e, src % S])
