"""Hierarchical tiny-MLP decoders + Gaussian Fourier embedding (functional).

Parameters are a plain nested dict of tensors with the JAX package's layout
(weights stored ``[in, out]``):

- ``MLP`` (middle / fine / color): Fourier-embedded xyz (93-d
  ``sin(x @ B)``, ``B`` frozen), 5 dense layers of width ``hidden`` with
  ReLU, a per-layer additive projection ``fc_c`` of the sampled grid
  feature, and the embedding re-concatenated after layer 2. The fine decoder
  concatenates the (detached) middle-level feature to its own.
- ``MLP_no_xyz`` (coarse): feature-only input; the skip re-concatenates the
  feature.
- :func:`nice_forward` routes by stage: coarse -> coarse occ; middle ->
  middle occ; fine -> middle + fine residual occ; color -> RGB with occ =
  middle + fine.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..ops.trilinear import sample_grid

Params = Dict[str, Any]

EMBEDDING_SIZE = 93
FOURIER_SCALE = 25.0
N_BLOCKS = 5
SKIPS = (2,)


class DecoderConfig(NamedTuple):
    c_dim: int = 32
    hidden: int = 32
    coarse: bool = True


def _dense_init(gen, d_in, d_out, relu_gain=True):
    """Xavier-uniform weight ``[in, out]``, zero bias."""
    gain = math.sqrt(2.0) if relu_gain else 1.0
    a = gain * math.sqrt(6.0 / (d_in + d_out))
    w = torch.rand((d_in, d_out), generator=gen) * (2 * a) - a
    return {"w": w, "b": torch.zeros((d_out,))}


def _init_mlp(gen, cfg: DecoderConfig, concat_feature: bool, color: bool):
    c_in = cfg.c_dim * (2 if concat_feature else 1)
    linears = []
    d_in = EMBEDDING_SIZE
    for i in range(N_BLOCKS):
        linears.append(_dense_init(gen, d_in, cfg.hidden))
        d_in = cfg.hidden + (EMBEDDING_SIZE if i in SKIPS else 0)
    fc_c = [
        _dense_init(gen, c_in, cfg.hidden, relu_gain=False)
        for _ in range(N_BLOCKS)
    ]
    out = _dense_init(gen, d_in, 4 if color else 1, relu_gain=False)
    B = torch.randn((3, EMBEDDING_SIZE), generator=gen) * FOURIER_SCALE
    return {"linears": linears, "fc_c": fc_c, "out": out, "embed_B": B}


def _init_mlp_no_xyz(gen, cfg: DecoderConfig):
    linears = []
    d_in = cfg.c_dim
    for i in range(N_BLOCKS):
        linears.append(_dense_init(gen, d_in, cfg.hidden))
        d_in = cfg.hidden + (cfg.c_dim if i in SKIPS else 0)
    out = _dense_init(gen, d_in, 1, relu_gain=False)
    return {"linears": linears, "out": out}


def init_decoders(
    cfg: DecoderConfig = DecoderConfig(),
    gen: Optional[torch.Generator] = None,
    device="cuda",
) -> Params:
    """Random decoders (Xavier-uniform, ``B ~ N(0, 25^2)``) from ``gen``."""
    params = {
        "coarse": _init_mlp_no_xyz(gen, cfg),
        "middle": _init_mlp(gen, cfg, concat_feature=False, color=False),
        "fine": _init_mlp(gen, cfg, concat_feature=True, color=False),
        "color": _init_mlp(gen, cfg, concat_feature=False, color=True),
    }
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree):
    """Map ``fn`` over the tensor leaves of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Tensor leaves of nested dicts / lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def fourier_embed(p: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Random Fourier features ``sin(p @ B)``; ``B`` is frozen (detached)."""
    return torch.sin(p @ B.detach())


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _mlp_forward(params, pts, feat):
    h = fourier_embed(pts, params["embed_B"])
    embedded = h
    for i, (lin, fc) in enumerate(zip(params["linears"], params["fc_c"])):
        h = torch.relu(_dense(lin, h))
        h = h + _dense(fc, feat)
        if i in SKIPS:
            h = torch.cat([embedded, h], dim=-1)
    return _dense(params["out"], h)


def _mlp_no_xyz_forward(params, feat):
    h = feat
    for i, lin in enumerate(params["linears"]):
        h = torch.relu(_dense(lin, h))
        if i in SKIPS:
            h = torch.cat([feat, h], dim=-1)
    return _dense(params["out"], h)


def _feat(grids, bounds, name, pts):
    return sample_grid(grids[name], pts, bounds[name])


def _geo_occ(params, grids, bounds, pts):
    """fine + middle residual occupancy with the middle feature sampled ONCE:
    the middle decoder reads it live, the fine decoder detached."""
    mid_feat = _feat(grids, bounds, "middle", pts)
    mid_occ = _mlp_forward(params["middle"], pts, mid_feat)[..., 0]
    own = _feat(grids, bounds, "fine", pts)
    feat = torch.cat([own, mid_feat.detach()], dim=-1)
    fine_occ = _mlp_forward(params["fine"], pts, feat)[..., 0]
    return fine_occ + mid_occ


def nice_forward(
    params: Params,
    grids: Dict[str, torch.Tensor],
    pts: torch.Tensor,
    bounds: Dict[str, torch.Tensor],
    stage: str,
) -> torch.Tensor:
    """Stage-routed hierarchy forward: points ``[N, 3]`` -> raw ``[N, 4]``
    (rgb in channels 0-2, zero outside the color stage; occupancy in 3)."""
    n = pts.shape[0]
    zeros3 = torch.zeros((n, 3), dtype=pts.dtype, device=pts.device)
    if stage == "coarse":
        occ = _mlp_no_xyz_forward(
            params["coarse"], _feat(grids, bounds, "coarse", pts)
        )[..., 0]
    elif stage == "middle":
        occ = _mlp_forward(
            params["middle"], pts, _feat(grids, bounds, "middle", pts)
        )[..., 0]
    elif stage == "fine":
        occ = _geo_occ(params, grids, bounds, pts)
    elif stage == "color":
        raw = _mlp_forward(params["color"], pts, _feat(grids, bounds, "color", pts))
        occ = _geo_occ(params, grids, bounds, pts)
        return torch.cat([raw[:, :3], occ[:, None]], dim=-1)
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return torch.cat([zeros3, occ[:, None]], dim=-1)
