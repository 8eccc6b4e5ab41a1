"""Pretrained decoders: the repo's flat ``.npz`` format and upstream ``.pt``.

``.npz`` (``models/pretrained_decoders.npz``) holds one array per decoder
leaf under keys like ``middle/linears/0/w`` (weights stored ``[in, out]``),
81 keys for the four decoders. Loading it is strict: every leaf of the model
must be present with the same shape. :func:`save_decoders_npz` writes it
(``pretrain_decoders.py`` makes decoders in this format).

``.pt`` is an upstream NICE-SLAM ``torch.save`` of a decoder state dict
(optionally wrapped as ``{"model": ...}``), mapped as the JAX package's
``models/pretrained.py`` maps it:

  <level>_decoder.pts_linears.{i}.weight/bias    -> params[level]['linears'][i]
  <level>_decoder.fc_c.{i}.weight/bias           -> params[level]['fc_c'][i]
  <level>_decoder.output_linear.weight/bias      -> params[level]['out']
  <level>_decoder.embedder._B or .B (if saved)   -> params[level]['embed_B']

with ``[out, in]`` weights transposed to ``[in, out]``; a missing key keeps
the leaf's init. :func:`load_pretrained_decoders` dispatches as the JAX one.
"""
from __future__ import annotations

from typing import Dict

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


def save_decoders_npz(path: str, params) -> None:
    """Write a decoder tree as the flat ``.npz`` that :func:`load_decoders_npz`
    and the JAX package's loader read: one float32 array per leaf, keyed by
    its slash-joined path, read back from whatever device holds it."""
    np.savez(path, **{
        key: np.asarray(leaf.detach().cpu().numpy(), np.float32)
        for key, leaf in _flatten_with_keys(params)
    })


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


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The tensors of an upstream ``.pt`` (unwrapping ``{"model": ...}``) as
    float32 numpy arrays."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    return {
        k: np.asarray(v.detach().cpu().numpy(), np.float32)
        for k, v in blob.items() if hasattr(v, "detach")
    }


def _like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=leaf.dtype).to(leaf.device)


def _apply_level(params_level, sd: Dict[str, np.ndarray], prefix: str):
    """Overlay the ``prefix.*`` entries of ``sd`` onto one decoder's params."""
    out = dict(params_level)
    for group in ("linears", "fc_c"):
        if group not in out:
            continue
        name = "pts_linears" if group == "linears" else group
        for i in range(len(out[group])):
            w = sd.get(f"{prefix}.{name}.{i}.weight")
            if w is not None:
                b = sd[f"{prefix}.{name}.{i}.bias"]
                old = out[group][i]
                out[group] = list(out[group])
                out[group][i] = {"w": _like(w.T, old["w"]), "b": _like(b, old["b"])}
    w = sd.get(f"{prefix}.output_linear.weight")
    if w is not None:
        old = out["out"]
        out["out"] = {"w": _like(w.T, old["w"]),
                      "b": _like(sd[f"{prefix}.output_linear.bias"], old["b"])}
    for bkey in (f"{prefix}.embedder._B", f"{prefix}.embedder.B"):
        if bkey in sd and "embed_B" in out:
            out["embed_B"] = _like(sd[bkey], out["embed_B"])
    return out


def load_pretrained_decoders(params, coarse_path: str = "", middle_fine_path: str = ""):
    """Overlay pretrained checkpoints onto ``params`` as the JAX package
    does: a ``.npz`` middle/fine path is the whole decoder tree and wins (the
    coarse path is then ignored); otherwise the ``.pt`` coarse checkpoint
    (``coarse_decoder.*``, then ``decoder.*``) and the ``.pt`` middle/fine one
    (``middle_decoder.*``, ``fine_decoder.*``) overlay their levels, and
    missing keys keep their init."""
    if middle_fine_path and middle_fine_path.endswith(".npz"):
        return load_decoders_npz(middle_fine_path, params)
    if coarse_path:
        sd = load_state_dict(coarse_path)
        params = dict(params)
        params["coarse"] = _apply_level(params["coarse"], sd, "coarse_decoder")
        params["coarse"] = _apply_level(params["coarse"], sd, "decoder")
    if middle_fine_path:
        sd = load_state_dict(middle_fine_path)
        params = dict(params)
        params["middle"] = _apply_level(params["middle"], sd, "middle_decoder")
        params["fine"] = _apply_level(params["fine"], sd, "fine_decoder")
    return params


def upstream_state_dict(params, levels=("coarse", "middle", "fine")):
    """``params``' ``levels`` under upstream names, weights ``[out, in]``, on
    the CPU: what an upstream ``torch.save`` of those decoders holds, and
    what :func:`load_pretrained_decoders` maps back."""
    sd = {}
    for lvl in levels:
        p, pre = params[lvl], f"{lvl}_decoder"
        for group, name in (("linears", "pts_linears"), ("fc_c", "fc_c")):
            for i, lin in enumerate(p.get(group, [])):
                sd[f"{pre}.{name}.{i}.weight"] = lin["w"].detach().T.contiguous().cpu()
                sd[f"{pre}.{name}.{i}.bias"] = lin["b"].detach().cpu()
        sd[f"{pre}.output_linear.weight"] = p["out"]["w"].detach().T.contiguous().cpu()
        sd[f"{pre}.output_linear.bias"] = p["out"]["b"].detach().cpu()
        if "embed_B" in p:
            sd[f"{pre}.embedder._B"] = p["embed_B"].detach().cpu()
    return sd
