"""The port's decoders (on the shipped pretrained weights, carried across
with convert.py) and renderer against the JAX package.

Tolerances: 1e-5 on decoder outputs; 1e-4 on render outputs (summation
order differs in the small matmuls and the cumulative product).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.grid.hierarchy import GridConfig as JGridConfig
from niceslam_tpu.grid.hierarchy import init_grids as jinit_grids
from niceslam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.models.decoders import nice_forward as jnice_forward
from niceslam_tpu.models.pretrained import load_decoders_npz as jload_npz
from niceslam_tpu.render.renderer import RenderConfig as JRenderConfig
from niceslam_tpu.render.renderer import render_rays as jrender_rays
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders, nice_forward
from niceslam_tpu_torch.models.pretrained import load_decoders_npz
from niceslam_tpu_torch.render.renderer import RenderConfig, render_rays

torch.set_num_threads(1)

NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "pretrained_decoders.npz",
)
BOUND = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)
STAGES = ["coarse", "middle", "fine", "color"]


@pytest.fixture(scope="module")
def world():
    """JAX pretrained decoders + random grids, and the port's copies."""
    jdec = jload_npz(NPZ, jinit_decoders(jax.random.PRNGKey(0), JDecoderConfig()))
    gcfg = JGridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25, color_len=0.25,
                       bound_divisable=0.25)
    jgrids, jbounds, sb = jinit_grids(jax.random.PRNGKey(1), BOUND, gcfg)
    # Larger-than-init features so every decoder input matters.
    rng = np.random.default_rng(0)
    jgrids = {k: jnp.asarray(rng.normal(size=g.shape).astype(np.float32) * 0.3)
              for k, g in jgrids.items()}
    np_tree = jax.tree_util.tree_map(np.asarray, (jdec, jgrids, jbounds))
    dec = convert.decoders_from_jax(np_tree[0], "cpu")
    grids = convert.grids_from_jax(np_tree[1], "cpu")
    bounds, scene = convert.bounds_from_jax(np_tree[2], sb, "cpu")
    return (jdec, jgrids, jbounds, jnp.asarray(sb)), (dec, grids, bounds, scene)


def test_npz_loader_matches_converted_jax_tree(world):
    (jdec, *_), (dec, *_) = world
    from niceslam_tpu_torch.models.pretrained import _flatten_with_keys

    want = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp): leaf
        for kp, leaf in jax.tree_util.tree_flatten_with_path(jdec)[0]
    }
    got = load_decoders_npz(NPZ, init_decoders(DecoderConfig(), device="cpu"))
    for tree in (got, dec):
        flat = dict(_flatten_with_keys(tree))
        assert sorted(flat) == sorted(want) and len(flat) == 81
        for k, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("stage", STAGES)
def test_nice_forward_all_stages(world, stage):
    (jdec, jgrids, jbounds, _), (dec, grids, bounds, _) = world
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.4, 2.4, (300, 3)).astype(np.float32)
    want = jnice_forward(jdec, jgrids, jnp.asarray(pts), jbounds, stage)
    got = nice_forward(dec, grids, torch.from_numpy(pts), bounds, stage)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", STAGES)
def test_render_rays(world, stage):
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb) = world
    rng = np.random.default_rng(2)
    n = 64
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    gt = rng.uniform(0.5, 2.5, n).astype(np.float32)
    gt[:4] = 0.0
    jcfg = JRenderConfig(n_samples=16, n_surface=8, surface_band=0.03)
    cfg = RenderConfig(*jcfg)
    want = jrender_rays(jdec, jgrids, jbounds, jsb, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(gt), stage, jcfg)
    got = render_rays(dec, grids, bounds, sb, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(gt), stage, cfg)
    for name in ("rgb", "depth", "depth_var", "weights", "occ", "z_vals"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-4, atol=1e-4, err_msg=name,
        )
    np.testing.assert_array_equal(got.sample_valid.numpy(), np.asarray(want.sample_valid))
