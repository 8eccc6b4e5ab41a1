"""The port's ``render_image``, ``rays_for_image``, visualizer panel and
profiling hooks against the JAX package's.

Tolerances: 1e-5 on ``render_image``'s outputs and the rays (fp32 sums in
another order); the panel bit for bit from the same render outputs, and
within one level of 255 when each package renders its own.
"""
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.core.rays import Intrinsics as JIntrinsics
from niceslam_tpu.core.rays import rays_for_image as jrays_for_image
from niceslam_tpu.render.renderer import RenderConfig as JRenderConfig
from niceslam_tpu.render.renderer import render_image as jrender_image
from niceslam_tpu.utils import visualizer as jvis
from niceslam_tpu_torch.core.rays import Intrinsics, rays_for_image
from niceslam_tpu_torch.io.datasets.synthetic import circular_trajectory
from niceslam_tpu_torch.io.png import read_png_rgb
from niceslam_tpu_torch.render.renderer import RenderConfig, render_image
from niceslam_tpu_torch.utils import visualizer
from niceslam_tpu_torch.utils.profiling import annotate, trace

from test_torch_decoders_render import world  # noqa: F401  (fixture)

torch.set_num_threads(1)

# H = 21 is no multiple of rows_per_chunk = 8: three rows of padding.
INTR = dict(H=21, W=16, fx=12.0, fy=12.0, cx=8.0, cy=10.5)
ROWS = 8
JCFG = JRenderConfig(n_samples=16, n_surface=8, surface_band=0.03)


def _inputs():
    rng = np.random.default_rng(6)
    c2w = circular_trajectory(6)[2]
    depth = rng.uniform(0.6, 2.4, (INTR["H"], INTR["W"])).astype(np.float32)
    depth[:2, :3] = 0.0
    color = rng.uniform(0, 1, (INTR["H"], INTR["W"], 3)).astype(np.float32)
    return c2w, depth, color


def test_rays_for_image_matches_jax():
    c2w, _, _ = _inputs()
    want = jrays_for_image(JIntrinsics(**INTR), jnp.asarray(c2w))
    got = rays_for_image(Intrinsics(**INTR), torch.from_numpy(c2w))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (INTR["H"], INTR["W"], 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_depth", [True, False], ids=["gt_depth", "no_depth"])
def test_render_image_matches_jax(world, with_depth):  # noqa: F811
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb) = world
    c2w, depth, _ = _inputs()
    want = jrender_image(jdec, jgrids, jbounds, jsb, JIntrinsics(**INTR), jnp.asarray(c2w),
                         jnp.asarray(depth) if with_depth else None, "color", JCFG, ROWS)
    got = render_image(dec, grids, bounds, sb, Intrinsics(**INTR), torch.from_numpy(c2w),
                       torch.from_numpy(depth) if with_depth else None, "color",
                       RenderConfig(*JCFG), ROWS)
    for name in ("rgb", "depth", "depth_var", "weights"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape and not g.requires_grad, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


class _Out:
    def __init__(self, rgb, depth):
        self.rgb, self.depth = rgb, depth


def test_panel_bit_equal_to_jax_on_the_same_render(tmp_path, monkeypatch):
    """Both visualizers given the same render outputs write the same pixels
    (the JAX one through cv2 in BGR, the port's through io/png.py in RGB)."""
    c2w, depth, color = _inputs()
    rng = np.random.default_rng(7)
    rgb = rng.uniform(-0.1, 1.1, color.shape).astype(np.float32)
    rdepth = (depth + rng.normal(0, 0.1, depth.shape)).astype(np.float32)
    monkeypatch.setattr(jvis, "render_image", lambda *a, **k: _Out(jnp.asarray(rgb),
                                                                    jnp.asarray(rdepth)))
    monkeypatch.setattr(visualizer, "render_image", lambda *a, **k: _Out(
        torch.from_numpy(rgb), torch.from_numpy(rdepth)))
    args = (None, None, None, None, None, c2w, color, depth, None)
    jpath = jvis.save_frame_vis(str(tmp_path / "jax"), 3, *args[:4], JIntrinsics(**INTR),
                                *args[5:])
    path = visualizer.save_frame_vis(str(tmp_path / "port"), 3, *args[:3], torch.zeros(3, 2),
                                     Intrinsics(**INTR), *args[5:])
    assert os.path.basename(path) == os.path.basename(jpath) == "frame_000003.png"
    want = cv2.imread(jpath, cv2.IMREAD_COLOR)[..., ::-1]
    assert want.shape == (INTR["H"], 5 * INTR["W"], 3)
    np.testing.assert_array_equal(read_png_rgb(path), want)
    np.testing.assert_array_equal(visualizer.make_panel(color, depth, rgb, rdepth), want)


def test_panel_end_to_end_within_one_level(world, tmp_path):  # noqa: F811
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, sb) = world
    c2w, depth, color = _inputs()
    jpath = jvis.save_frame_vis(str(tmp_path), 0, jdec, jgrids, jbounds, jsb,
                                JIntrinsics(**INTR), c2w, color, depth, JCFG)
    want = cv2.imread(jpath, cv2.IMREAD_COLOR)[..., ::-1].astype(np.int64)
    path = visualizer.save_frame_vis(str(tmp_path / "port"), 0, dec, grids, bounds, sb,
                                     Intrinsics(**INTR), c2w, color, depth,
                                     RenderConfig(*JCFG))
    got = read_png_rgb(path).astype(np.int64)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_trace_names_the_annotated_ranges(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "prof")):
        with annotate("track"):
            y = x @ x
        with annotate("map"):
            y = y @ x
    assert float(y[0, 0]) == 64.0 * 64.0
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in ranges] == ["track", "map"]
    assert not torch.cuda.is_initialized()  # no NVTX call on the CPU-only build
