"""The port's mesher (``niceslam_tpu_torch/eval/mesher.py``) against the JAX
package's on the same inputs, and the six cases of
``tests/unit/test_mesher.py`` on the port.

Tolerances: the occupancy field 1e-5 (decoder outputs; sums in the small
matmuls run in another order); marching tetrahedra and the PLY writer are
the same numpy code, so their outputs are held equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.core.rays import Intrinsics as JIntrinsics
from niceslam_tpu.eval import mesher as jmesher
from niceslam_tpu.grid.hierarchy import GridConfig as JGridConfig
from niceslam_tpu.grid.hierarchy import init_grids as jinit_grids
from niceslam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.models.decoders import nice_forward as jnice_forward
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.config.schema import MeshingConfig
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.eval import mesher
from niceslam_tpu_torch.ops import packed_kernels as pk
from niceslam_tpu_torch.ops.trilinear import sampler_route

torch.set_num_threads(1)

BOUND = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)


def make_sphere_field(R=0.6, n=32, extent=1.0):
    xs = np.linspace(-extent, extent, n)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1)
    field = R - np.sqrt(X**2 + Y**2 + Z**2)  # occupancy-style: positive inside
    return field, pts


def make_two_blob_field(n=32, extent=1.0):
    xs = np.linspace(-extent, extent, n)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1)
    big = 0.35 - np.sqrt((X + 0.5) ** 2 + Y**2 + Z**2)
    small = 0.15 - np.sqrt((X - 0.6) ** 2 + Y**2 + Z**2)
    return np.maximum(big, small), pts


@pytest.fixture(scope="module")
def world():
    """JAX random decoders and grids, and the port's copies on the CPU."""
    jdec = jinit_decoders(jax.random.PRNGKey(0), JDecoderConfig())
    gcfg = JGridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25, color_len=0.25,
                       bound_divisable=0.25)
    jgrids, jbounds, sb = jinit_grids(jax.random.PRNGKey(1), BOUND, gcfg)
    rng = np.random.default_rng(0)
    jgrids = {k: jnp.asarray(rng.normal(size=g.shape).astype(np.float32) * 0.3)
              for k, g in jgrids.items()}
    np_tree = jax.tree_util.tree_map(np.asarray, (jdec, jgrids, jbounds))
    dec = convert.decoders_from_jax(np_tree[0], "cpu")
    grids = convert.grids_from_jax(np_tree[1], "cpu")
    bounds, scene = convert.bounds_from_jax(np_tree[2], sb, "cpu")
    return (jdec, jgrids, jbounds, np.asarray(sb)), (dec, grids, bounds, scene)


# --------------------------------------------------- port vs JAX package
@pytest.mark.parametrize("route", ["fused", "packed"])
def test_query_occupancy_grid_matches_jax(world, route):
    """Resolution 16 (4,096 points) in chunks of 1,000: the last chunk is
    padded."""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, scene) = world
    want_occ, want_pts = jmesher.query_occupancy_grid(
        jdec, jgrids, jbounds, jsb, resolution=16, chunk=1000)
    pk.reset_launches()
    with sampler_route(route):
        occ, pts = mesher.query_occupancy_grid(
            dec, grids, bounds, scene, resolution=16, chunk=1000)
    assert occ.shape == (16, 16, 16) and pts.shape == (16, 16, 16, 3)
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_allclose(occ, want_occ, rtol=1e-5, atol=1e-5)
    assert pk.LAUNCHES == {"corner_table": 0, "gather_rows": 0, "scatter_corners": 0}


def test_extract_mesh_colors_match_jax(world):
    """The whole pipeline at resolution 16 on the packed route: the mesh of
    the port's own field, colored as the JAX package's color decoder colors
    the same vertices. (Whole meshes are not compared: a field difference
    at rounding level can move a vertex across the weld's 1e-6 lattice and
    reorder the vertex list.)"""
    (jdec, jgrids, jbounds, jsb), (dec, grids, bounds, scene) = world
    with sampler_route("packed"):
        v, f, c = mesher.extract_mesh(dec, grids, bounds, scene, resolution=16, chunk=1000)
        occ, pts = mesher.query_occupancy_grid(dec, grids, bounds, scene, resolution=16)
    want_v, want_f = mesher.marching_tetrahedra(occ, pts)
    assert len(f) > 0
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(f, want_f)
    raw = jnice_forward(jdec, jgrids, jnp.asarray(v.astype(np.float32)), jbounds, "color")
    np.testing.assert_allclose(c, np.clip(np.asarray(raw)[:, :3], 0, 1), rtol=1e-5, atol=1e-5)


def test_marching_tetrahedra_equals_jax(world):
    (jdec, jgrids, jbounds, jsb), _ = world
    occ, pts = jmesher.query_occupancy_grid(jdec, jgrids, jbounds, jsb, resolution=16)
    for field, p in (make_sphere_field(), make_two_blob_field(n=24), (occ, pts)):
        want_v, want_f = jmesher.marching_tetrahedra(field, p)
        got_v, got_f = mesher.marching_tetrahedra(field, p)
        assert len(got_f) > 0
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_f, want_f)


def test_write_ply_identical_bytes(tmp_path):
    field, pts = make_sphere_field(n=16)
    verts, faces = mesher.marching_tetrahedra(field, pts)
    colors = np.random.default_rng(0).uniform(0, 1, (len(verts), 3))
    for cols in (colors, None):
        mesher.write_ply(str(tmp_path / "port.ply"), verts, faces, cols)
        jmesher.write_ply(str(tmp_path / "jax.ply"), verts, faces, cols)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_postprocess_mesh_matches_jax():
    field, pts = make_two_blob_field()
    verts, faces = mesher.marching_tetrahedra(field, pts)
    colors = np.random.default_rng(1).uniform(0, 1, (len(verts), 3))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [-0.5, 0.0, -2.0]
    cam = dict(H=100, W=100, fx=200.0, fy=200.0, cx=50.0, cy=50.0)
    mcfg = MeshingConfig(get_largest_components=True)
    got = mesher.postprocess_mesh(verts, faces, colors, mcfg, c2w[None], Intrinsics(**cam))
    want = jmesher.postprocess_mesh(verts, faces, colors, mcfg, c2w[None], JIntrinsics(**cam))
    assert 0 < len(got[1]) < len(faces)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------- tests/unit/test_mesher.py on the port
def test_sphere_isosurface_radius():
    field, pts = make_sphere_field()
    verts, faces = mesher.marching_tetrahedra(field, pts, level=0.0)
    assert len(verts) > 200
    assert len(faces) > 200
    r = np.linalg.norm(verts, axis=1)
    np.testing.assert_allclose(r.mean(), 0.6, atol=0.02)
    assert r.std() < 0.02
    assert faces.max() < len(verts)


def test_empty_field_yields_empty_mesh():
    field, pts = make_sphere_field()
    verts, faces = mesher.marching_tetrahedra(field - 10.0, pts, level=0.0)
    assert len(verts) == 0 and len(faces) == 0


def test_ply_writer(tmp_path):
    field, pts = make_sphere_field(n=16)
    verts, faces = mesher.marching_tetrahedra(field, pts)
    colors = np.tile([[1.0, 0.0, 0.0]], (len(verts), 1))
    p = tmp_path / "m.ply"
    mesher.write_ply(str(p), verts, faces, colors)
    txt = p.read_text().splitlines()
    assert txt[0] == "ply"
    assert f"element vertex {len(verts)}" in txt[2]


def test_largest_components_drops_blob():
    field, pts = make_two_blob_field()
    verts, faces = mesher.marching_tetrahedra(field, pts)
    v2, f2, _ = mesher.largest_components(verts, faces, keep=1)
    assert 0 < len(f2) < len(faces)
    assert (v2[:, 0] < 0.0).all()  # only the big (-0.5-centred) blob is kept
    assert f2.max() < len(v2)


def test_cull_unseen_keeps_viewed_blob():
    field, pts = make_two_blob_field()
    verts, faces = mesher.marching_tetrahedra(field, pts)
    # one camera at z=-2 looking +z straight at the big blob, narrow fov
    intr = Intrinsics(H=100, W=100, fx=200.0, fy=200.0, cx=50.0, cy=50.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [-0.5, 0.0, -2.0]
    v2, f2, _ = mesher.cull_unseen(verts, faces, None, c2w[None], intr)
    assert 0 < len(f2) < len(faces)
    assert (v2[:, 0] < 0.2).all()  # the x=+0.6 blob is outside the frustum


def test_depth_test_culls_behind_surface():
    field, pts = make_two_blob_field()
    verts, faces = mesher.marching_tetrahedra(field, pts)
    intr = Intrinsics(H=100, W=100, fx=60.0, fy=60.0, cx=50.0, cy=50.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -2.0]
    # observed depth says every surface is at 1.0 m: vertices beyond about
    # 1.02 m from the camera are culled by the depth test
    depths = np.full((1, 100, 100), 1.0, np.float32)
    v2, f2, _ = mesher.cull_unseen(
        verts, faces, None, c2w[None], intr, depths=depths,
        bound_scale=1.02, depth_test=True,
    )
    if len(v2):
        assert (v2[:, 2] <= -2.0 + 1.03).all()
    assert len(f2) < len(faces)
