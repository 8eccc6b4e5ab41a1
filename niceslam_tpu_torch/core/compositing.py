"""Volumetric compositing: raw decoder outputs -> rgb / depth / depth-variance.

``occupancy=True``: ``alpha = sigmoid(10 * occ)``; ``occupancy=False``
(NeRF density): ``alpha = 1 - exp(-relu(occ) * dist)``. Transmittance is the
exclusive cumulative product of ``1 - alpha + 1e-10``, whose factors are
never zero, so :func:`cumprod_nonzero` computes it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    depth_var: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]
    # Per-sample auxiliaries for the mapper's free-space loss: decoder
    # occupancy logits before the out-of-bound override, the sample depths,
    # and the in-scene-bound mask. None where the producer does not set them.
    occ: Optional[torch.Tensor] = None  # [N, S]
    z_vals: Optional[torch.Tensor] = None  # [N, S]
    sample_valid: Optional[torch.Tensor] = None  # [N, S] bool


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod(x, dim=-1)`` of an ``x`` without zeros, with the
    derivative formulas torch uses for that case, op for op (the same bits),
    but without torch's host-side test ``(x == 0).any()`` in the backward,
    which waits for the stream on every backward pass."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.cumprod(x, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x, output)
        ctx.save_for_forward(x, output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)

    @staticmethod
    def jvp(ctx, x_t):
        x, out = ctx.saved_tensors
        return (x_t / x).cumsum(-1) * out


def cumprod_nonzero(x: torch.Tensor) -> torch.Tensor:
    """Cumulative product over the last axis of ``x``, whose entries must be
    non-zero; differentiable in reverse and forward mode."""
    return _CumprodNonzero.apply(x)


def raw_to_outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    occupancy: bool = True,
) -> RenderOutputs:
    """Composite per-sample ``raw = [..., S, 4]`` (rgb, occ) along each ray."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = raw[..., :3]
    occ = raw[..., 3]
    if occupancy:
        alpha = torch.sigmoid(10.0 * occ)
    else:
        alpha = 1.0 - torch.exp(-torch.relu(occ) * dists)

    one_minus = 1.0 - alpha + 1e-10
    transmittance = cumprod_nonzero(
        torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], dim=-1)
    )
    weights = alpha * transmittance

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return RenderOutputs(rgb_map, depth_map, depth_var, weights)
