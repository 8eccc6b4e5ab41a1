"""The decoder MLP's forward-mode CUDA kernel, its plain version, and the op
that binds it for the Gauss-Newton tracker's Jacobian.

- ``decoder_jvp`` (K6, ``csrc/decoder_jvp.cu``) computes one MLP of
  ``models/decoders.py`` (middle, fine or color: Fourier embedding, five
  ReLU layers with the feature term, the skip after layer 2) at ``N``
  points, value and ``T`` forward-mode tangents together, every layer kept
  in shared memory and registers: only ``raw [N, O]`` and ``raw_dot [T, N,
  O]`` reach device memory. It replaces no Pallas kernel (XLA fused the JAX
  package's decoders); the plain MLP under ``torch.func.jacfwd`` wrote each
  layer's ``[T, N, 32]`` tangent to device memory and read it back. Its
  bound is fp32 FFMA, and it computes in fp32 only.
- :func:`decoder_jvp_plain` is the same function in plain PyTorch: value
  and tangents as one ``[1 + T, N, W]`` batch through the same layers.
- :class:`DecoderMLP` is one MLP call ``(weights, pts, feat, detached) ->
  raw [N, O]`` whose ``jvp`` calls :class:`_DecoderTangents`, whose
  ``vmap`` rule folds ``jacfwd``'s batch of tangents into the kernel's
  ``T``: the six pose tangents of a linearization go in one launch. Its
  forward launches nothing: it returns a buffer that the ``jvp``'s launch
  fills with the value beside the tangents (the value rows set the ReLU
  masks), so a call must be differentiated in forward mode
  (:func:`deferred` counts the buffers still unwritten). It has no reverse
  mode: the mapper, the Adam tracker, the image renderer and the mesher
  differentiate or run the plain MLP of ``models/decoders.py``.

The weights are packed into one flat float32 tensor (:func:`pack_weights`,
laid out by :func:`layout`, the kernel's ``layout``). ``detached`` is the
fine decoder's detached middle feature: it enters the value rows only, so
the kernel does no tangent work for it.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version. ``LAUNCHES`` counts the kernel's launches and ``JVP_TALLY`` splits
them by ``(T, N)`` (``T = 0``: the value alone, where ``decoder_jvp`` is
called with no tangents); ``COUNTERS`` names both, carried over graph
replays by ``slam/programs.add_replays``.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from .trilerp_kernels import CSRC, _launch_check, load_library

LAUNCHES = {"decoder_jvp": 0}
# K6's launches by (T, N); their sum is LAUNCHES["decoder_jvp"].
JVP_TALLY: Counter = Counter()
COUNTERS = {"LAUNCHES": LAUNCHES, "JVP_TALLY": JVP_TALLY}

SRC = CSRC / "decoder_jvp.cu"
EMBED = 93  # models/decoders.EMBEDDING_SIZE
N_BLOCKS = 5
SKIP = 2
KERNEL_T = 6  # tangents of a launch (or none); others go in launches of 6
KERNEL_WIDTH = 32  # hidden width and feature channels the kernel takes
# K6 against its plain version on the card: fp32 on both sides, the kernel's
# sums in another order (fmaf chains over k, the embedding's sincosf) than
# the plain version's products. A point whose ReLU pre-activation lies within
# rounding of 0 can take the other mask in the two orders, and its tangent
# jumps there (its value is continuous): at most KINKS of the tangents may
# differ beyond CARD_RTOL (:func:`tangents_off`).
CARD_RTOL = 1e-4
KINKS = 1e-4
_LIB = None


def reset_launches() -> None:
    LAUNCHES["decoder_jvp"] = 0
    JVP_TALLY.clear()


def _lib():
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB = load_library(SRC, {
            "decoder_jvp": [p, p, p, p, p, p, p, p, i, i, i, p],
            "decoder_jvp_weights": [i, i],
        })
    return _LIB


def layout(c_in: int, hidden: int, out_dim: int) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """Offset and shape of each piece of the packed weights: ``W{i}``,
    ``b{i}`` (the five layers; ``W3`` takes ``cat(embedding, h)``),
    ``F{i}``, ``c{i}`` (the feature terms), ``Wo``, ``bo``, ``B`` (the
    embedding), in that order; ``"total"`` the floats in all."""
    out, o = {}, 0

    def put(name, *shape):
        nonlocal o
        out[name] = (o, shape)
        o += math.prod(shape)

    for i in range(N_BLOCKS):
        put(f"W{i}", EMBED if i == 0 else hidden + (EMBED if i == SKIP + 1 else 0), hidden)
        put(f"b{i}", hidden)
    for i in range(N_BLOCKS):
        put(f"F{i}", c_in, hidden)
        put(f"c{i}", hidden)
    put("Wo", hidden, out_dim)
    put("bo", out_dim)
    put("B", 3, EMBED)
    out["total"] = (o, ())
    return out


def pack_weights(params) -> torch.Tensor:
    """One MLP's parameters (``models/decoders._init_mlp``'s layout) as the
    flat float32 tensor of :func:`layout`, detached: constants of the
    forward-mode op."""
    parts = []
    for lin in params["linears"]:
        parts += [lin["w"], lin["b"]]
    for fc in params["fc_c"]:
        parts += [fc["w"], fc["b"]]
    parts += [params["out"]["w"], params["out"]["b"], params["embed_B"]]
    return torch.cat([p.detach().reshape(-1) for p in parts])


def unpack(weights: torch.Tensor, c_in: int, hidden: int, out_dim: int):
    """Views of :func:`pack_weights`' pieces, by :func:`layout`'s names."""
    lay = layout(c_in, hidden, out_dim)
    if weights.shape != (lay["total"][0],):
        raise ValueError(f"packed weights of {tuple(weights.shape)}, expected "
                         f"({lay['total'][0]},) for c_in {c_in}, hidden {hidden}, "
                         f"out {out_dim}")
    return {name: weights[o:o + math.prod(shape)].reshape(shape)
            for name, (o, shape) in lay.items() if name != "total"}


def _with_bias(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [1 + T, ...]`` with ``b`` added to the value row only."""
    return torch.cat([a[:1] + b, a[1:]])


def decoder_jvp_plain(
    weights: torch.Tensor, pts: torch.Tensor, pts_dot: torch.Tensor,
    feat: torch.Tensor, feat_dot: torch.Tensor, detached: Optional[torch.Tensor],
    hidden: int, out_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6: ``(raw [N, O], raw_dot [T, N, O])``. Row 0 of each
    ``[1 + T, N, W]`` batch is the value, rows 1.. the tangents: a dense
    layer adds its bias to the value row only, the ReLU's mask is the value
    row's pre-activation > 0 (``torch.relu``'s jvp rule)."""
    c_in = feat.shape[-1] + (0 if detached is None else detached.shape[-1])
    p = unpack(weights, c_in, hidden, out_dim)
    z = torch.cat([pts[None], pts_dot]) @ p["B"]  # [1 + T, N, 93]
    e = torch.cat([torch.sin(z[:1]), torch.cos(z[:1]) * z[1:]])
    f = torch.cat([feat[None], feat_dot])
    C = feat.shape[-1]
    h = e
    for i in range(N_BLOCKS):
        a = _with_bias(h @ p[f"W{i}"], p[f"b{i}"])
        h = torch.cat([torch.relu(a[:1]), torch.where(a[:1] > 0, a[1:], 0.0)])
        fc = f @ p[f"F{i}"][:C]
        if detached is not None:
            fc = torch.cat([fc[:1] + detached @ p[f"F{i}"][C:], fc[1:]])
        h = h + _with_bias(fc, p[f"c{i}"])
        if i == SKIP:
            h = torch.cat([e, h], dim=-1)
    out = _with_bias(h @ p["Wo"], p["bo"])
    return out[0], out[1:]


def tangents_off(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of tangents ``got`` off ``want`` by more than ``CARD_RTOL``
    of ``|want|`` plus the largest ``|want|``."""
    scale = float(want.abs().max())
    return float(((got - want).abs() > CARD_RTOL * (want.abs() + scale)).float().mean())


def _check(weights, pts, pts_dot, feat, feat_dot, detached, hidden, out_dim):
    dev = pts.device
    named = [("weights", weights), ("pts", pts), ("pts_dot", pts_dot), ("feat", feat),
             ("feat_dot", feat_dot)] + ([("detached", detached)] if detached is not None else [])
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, pts on {dev}")
    N, T = pts.shape[0], pts_dot.shape[0]
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be [N, 3], got {tuple(pts.shape)}")
    if tuple(pts_dot.shape) != (T, N, 3):
        raise ValueError(f"pts_dot must be [T, N, 3], got {tuple(pts_dot.shape)}")
    if feat.dim() != 2 or feat.shape[0] != N:
        raise ValueError(f"feat must be [N, C], got {tuple(feat.shape)}")
    if tuple(feat_dot.shape) != (T, *feat.shape):
        raise ValueError(f"feat_dot must be [T, N, C], got {tuple(feat_dot.shape)}")
    if detached is not None and (detached.dim() != 2 or detached.shape[0] != N):
        raise ValueError(f"detached must be [N, C'], got {tuple(detached.shape)}")
    if dev.type == "cuda":
        widths = (hidden, feat.shape[1]) + (() if detached is None else (detached.shape[1],))
        if any(w != KERNEL_WIDTH for w in widths) or not 1 <= out_dim <= 4:
            raise ValueError(
                f"K6 takes hidden and feature widths of {KERNEL_WIDTH} and 1-4 outputs: "
                f"hidden {hidden}, feature {widths[1:]}, out {out_dim}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's float4 loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def decoder_jvp(
    weights: torch.Tensor, pts: torch.Tensor, pts_dot: torch.Tensor,
    feat: torch.Tensor, feat_dot: torch.Tensor, detached: Optional[torch.Tensor],
    hidden: int, out_dim: int, out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(raw [N, O], raw_dot [T, N, O])`` of the MLP packed in
    ``weights`` at ``pts [N, 3]`` with tangents ``pts_dot [T, N, 3]``,
    feature ``feat [N, C]`` with tangents ``feat_dot [T, N, C]``, and the
    tangent-free ``detached [N, C']`` after it (or None). ``out``, a
    contiguous ``[N, O]`` float32 tensor, receives ``raw`` if given."""
    _check(weights, pts, pts_dot, feat, feat_dot, detached, hidden, out_dim)
    N, T = pts.shape[0], pts_dot.shape[0]
    if out is not None and (tuple(out.shape) != (N, out_dim) or not out.is_contiguous()
                            or out.dtype != torch.float32 or out.device != pts.device):
        raise ValueError(f"out must be a contiguous float32 [N, O] on {pts.device}")
    if pts.device.type == "cpu":
        val, tan = decoder_jvp_plain(weights, pts, pts_dot, feat, feat_dot, detached,
                                     hidden, out_dim)
        return (val, tan) if out is None else (out.copy_(val), tan)
    if out is None:
        out = torch.empty((N, out_dim), dtype=torch.float32, device=pts.device)
    out_dot = torch.empty((T, N, out_dim), dtype=torch.float32, device=pts.device)
    if N == 0:
        return out, out_dot
    weights, pts, feat = _aligned(weights), pts.contiguous(), _aligned(feat)
    pts_dot, feat_dot = pts_dot.contiguous(), _aligned(feat_dot)
    det = None if detached is None else _aligned(detached)
    with torch.cuda.device(pts.device):
        lib = _lib()
        stream = torch.cuda.current_stream().cuda_stream
        # Every launch writes the value (the same bits). Tangents go six at a
        # time, the last group padded with zero tangents.
        for t0 in range(0, max(T, 1), KERNEL_T):
            t = min(T - t0, KERNEL_T)
            xd, fd, od = pts_dot[t0:t0 + t], feat_dot[t0:t0 + t], out_dot[t0:t0 + t]
            if 0 < t < KERNEL_T:
                pad = KERNEL_T - t
                xd = torch.cat([xd, xd.new_zeros((pad, *xd.shape[1:]))])
                fd = torch.cat([fd, fd.new_zeros((pad, *fd.shape[1:]))])
                od = out_dot.new_empty((KERNEL_T, N, out_dim))
            rc = lib.decoder_jvp(
                weights.data_ptr(), pts.data_ptr(), xd.data_ptr() if t else None,
                feat.data_ptr(), fd.data_ptr() if t else None,
                None if det is None else det.data_ptr(), out.data_ptr(),
                od.data_ptr() if t else None, N, KERNEL_T if t else 0, out_dim, stream,
            )
            _launch_check(rc, "decoder_jvp")
            LAUNCHES["decoder_jvp"] += 1
            JVP_TALLY[KERNEL_T if t else 0, N] += 1
            if 0 < t < KERNEL_T:
                out_dot[t0:t0 + t] = od[:t]
    return out, out_dot


# -------------------------------------------------------- differentiable op
# Outputs of DecoderMLP forwards whose jvp has not filled them yet.
_DEFERRED: list = []


def deferred() -> int:
    """How many values of :class:`DecoderMLP` calls no jvp has written yet:
    0 once every call was differentiated."""
    return len(_DEFERRED)


class DecoderMLP(torch.autograd.Function):
    """``raw [N, O]`` of one MLP (packed ``weights``) at ``pts [N, 3]`` with
    feature ``feat [N, 32]`` and the tangent-free ``detached`` (or None),
    differentiable in forward mode in ``pts`` and ``feat``. ``shape`` is
    ``(hidden, out_dim)``. The forward launches nothing and returns an empty
    ``raw`` that the jvp's launch fills with the value beside the tangents:
    one launch a call, for a caller that differentiates every call
    (:func:`deferred` checks that)."""

    @staticmethod
    def forward(weights, pts, feat, detached, shape):
        _DEFERRED.append(pts.new_empty((pts.shape[0], shape[1])))
        return _DEFERRED[-1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        weights, pts, feat, detached, shape = inputs
        ctx.save_for_forward(weights, pts, feat, detached)
        ctx.shape = shape
        # (torch.func may set up a context more than once for one forward.)
        ctx.out = _DEFERRED[-1]

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "DecoderMLP is forward mode only: reverse-mode callers run the plain MLP")

    @staticmethod
    def jvp(ctx, w_dot, pts_dot, feat_dot, det_dot, _shape):
        # The weights and the detached feature are constants of the op: their
        # tangents (zeros under torch.func) are not read.
        weights, pts, feat, detached = ctx.saved_tensors
        if pts_dot is None:
            pts_dot = torch.zeros_like(pts)
        if feat_dot is None:
            feat_dot = torch.zeros_like(feat)
        out = ctx.out
        _DEFERRED[:] = [b for b in _DEFERRED if b is not out]
        return _DecoderTangents.apply(weights, pts, pts_dot[None], feat, feat_dot[None],
                                      detached, ctx.shape, out)[0]

    @staticmethod
    def vmap(info, in_dims, *args):
        # torch.func needs the rule; jacfwd batches only the tangents, which
        # _DecoderTangents' rule takes.
        raise NotImplementedError("DecoderMLP takes no batched primals")


class _DecoderTangents(torch.autograd.Function):
    """``raw_dot [T, N, O]`` of :class:`DecoderMLP` for tangents ``pts_dot [T,
    N, 3]`` and ``feat_dot [T, N, 32]``, as an op that ``torch.func``
    transforms can call from :meth:`DecoderMLP.jvp`; the value goes to
    ``out``. Its ``vmap`` rule folds the batch into
    ``T``. Not differentiable itself."""

    @staticmethod
    def forward(weights, pts, pts_dot, feat, feat_dot, detached, shape, out):
        return decoder_jvp(weights, pts, pts_dot, feat, feat_dot, detached, *shape, out=out)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("K6 has no derivative of its own")

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError("K6 has no derivative of its own")

    @staticmethod
    def vmap(info, in_dims, weights, pts, pts_dot, feat, feat_dot, detached, shape, out):
        wd, pd, pdd, fd, fdd, dd, _, od = in_dims
        if any(d is not None for d in (wd, pd, fd, dd, od)):
            raise NotImplementedError("_DecoderTangents batches only the tangents")
        # Batch b, tangent t -> tangent b * T + t of one call.
        B = info.batch_size
        P, F = (_batched(x, d, B) for x, d in ((pts_dot, pdd), (feat_dot, fdd)))
        T = P.shape[1]
        tan = _DecoderTangents.apply(weights, pts, P.reshape(B * T, *P.shape[2:]), feat,
                                     F.reshape(B * T, *F.shape[2:]), detached, shape, out)
        return tan.reshape(B, T, *tan.shape[1:]), 0


def _batched(x, dim, B):
    """``x`` with its batch dimension first (expanded where it has none)."""
    return x.expand(B, *x.shape) if dim is None else x.movedim(dim, 0)


def decoder_mlp(params, pts: torch.Tensor, feat: torch.Tensor,
                detached: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MLP of ``models/decoders.py`` (``params``: middle, fine or color)
    at ``pts [N, 3]`` with feature ``feat`` and, for the fine decoder, the
    detached middle feature after it, through :class:`DecoderMLP`: ``raw
    [N, O]``, filled by the call's jvp."""
    shape = (params["out"]["w"].shape[0], params["out"]["w"].shape[1])
    return DecoderMLP.apply(pack_weights(params), pts, feat, detached, shape)
