"""The port's upstream ``.pt`` decoder import against the JAX package's
``load_pretrained_decoders``, on the same initial decoders (carried across
with ``convert.py``) and the same files: every leaf equal, no tolerance."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from niceslam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.models.pretrained import load_pretrained_decoders as jload
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders
from niceslam_tpu_torch.models.pretrained import (
    _flatten_with_keys,
    load_decoders_npz,
    load_pretrained_decoders,
    upstream_state_dict,
)
from niceslam_tpu_torch.slam.system import NiceSLAM

from test_torch_slam import tiny_config

torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "models", "pretrained_decoders.npz")


def _source():
    """Upstream-named state dicts of decoders that differ from the init."""
    rng = np.random.default_rng(5)
    params = init_decoders(DecoderConfig(), device="cpu")
    params = {lvl: _map(p, lambda t: torch.from_numpy(
        rng.normal(size=tuple(t.shape)).astype(np.float32))) for lvl, p in params.items()}
    return upstream_state_dict(params, ("coarse", "middle", "fine"))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _save(path, sd, prefixes, rename=None, drop=(), wrap=False):
    out = {}
    for k, v in sd.items():
        if k.split(".")[0] in prefixes and k not in drop:
            out[k if rename is None else k.replace(*rename)] = v
    torch.save({"model": out} if wrap else out, path)
    return str(path)


CASES = {
    # upstream names; the embedding matrix saved as embedder._B
    "upstream": lambda sd, d: (_save(d / "c.pt", sd, ("coarse_decoder",)),
                               _save(d / "mf.pt", sd, ("middle_decoder", "fine_decoder"))),
    # a coarse export named just 'decoder', wrapped as {"model": ...}
    "alias_wrapped": lambda sd, d: (
        _save(d / "c.pt", sd, ("coarse_decoder",), rename=("coarse_decoder", "decoder"),
              wrap=True),
        _save(d / "mf.pt", sd, ("middle_decoder", "fine_decoder"), wrap=True)),
    # missing keys keep their init; embedder.B spelling
    "missing_keys": lambda sd, d: (
        _save(d / "c.pt", sd, ("coarse_decoder",),
              drop=("coarse_decoder.output_linear.weight",)),
        _save(d / "mf.pt", sd, ("middle_decoder", "fine_decoder"),
              rename=("embedder._B", "embedder.B"),
              drop=("fine_decoder.fc_c.3.weight", "middle_decoder.pts_linears.1.weight"))),
    # only a middle/fine checkpoint
    "middle_fine_only": lambda sd, d: (
        "", _save(d / "mf.pt", sd, ("middle_decoder", "fine_decoder"))),
    # a .npz middle/fine path is the whole tree and wins: the coarse .pt is ignored
    "npz_wins": lambda sd, d: (_save(d / "c.pt", sd, ("coarse_decoder",)), NPZ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pt_import_equals_jax(tmp_path, case):
    coarse, middle_fine = CASES[case](_source(), tmp_path)
    jinit = jinit_decoders(jax.random.PRNGKey(3), JDecoderConfig())
    init = convert.decoders_from_jax(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    want = jload(jinit, coarse, middle_fine)
    got = load_pretrained_decoders(init, coarse, middle_fine)
    want = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp): np.asarray(leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(want)[0]
    }
    got = dict(_flatten_with_keys(got))
    assert sorted(got) == sorted(want)
    changed = 0
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        changed += not np.array_equal(v.numpy(), np.asarray(_flat(jinit)[k]))
    assert changed > 0
    if case == "npz_wins":
        assert changed == len(got)


def _flat(tree):
    return {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp): leaf
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_upstream_round_trip_and_slam_loads_pt(tmp_path):
    """``.pt`` files exported from the shipped ``.npz`` load back to it bit for
    bit in NiceSLAM; the pretrained decoders stay frozen as with the .npz."""
    npz = load_decoders_npz(NPZ, init_decoders(DecoderConfig(), device="cpu"))
    sd = upstream_state_dict(npz)
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg,
        pretrained_coarse=_save(tmp_path / "c.pt", sd, ("coarse_decoder",)),
        pretrained_middle_fine=_save(tmp_path / "mf.pt", sd, ("middle_decoder", "fine_decoder")),
    )
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=2), device="cpu")
    assert slam.decoder_train == "never"
    for lvl in ("coarse", "middle", "fine"):
        got, want = dict(_flatten_with_keys(slam.state.decoders[lvl])), dict(
            _flatten_with_keys(npz[lvl]))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), (lvl, k)
