"""The port's packed corner-table route (K3 ``corner_table``, K4
``gather_rows``, K5 ``scatter_corners`` and ``PackedRows``; CPU plain
versions) against the JAX package: its packed sampler (``corner_table``,
the default ``sample_grid``) and the three Pallas kernels in interpret mode.

Tolerances: the table and the gather are copies, so bit-exact; 1e-5 on
values and on the scatter (sums in another order than JAX's), 2e-5 on
derivatives (as ``tests/unit/test_pallas_trilerp.py``), also between the
port's two routes, whose gradients sum in different orders; 1e-6 between
the two routes' values, which share the lerp expression order. The
bit-exact model of K5 on the card (``ops/fixed_point.py``) is held to 1e-5
of the float32 sums; its row-owner walk is held to the forward scatter
exactly (int64).
"""
import ast
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.ops import pallas_trilerp as jpal
from niceslam_tpu.ops import trilinear as jtri
from niceslam_tpu_torch.ops import fixed_point as fp
from niceslam_tpu_torch.ops import packed_kernels as pk
from niceslam_tpu_torch.ops import trilerp_kernels as tk
from niceslam_tpu_torch.ops.trilinear import (
    get_sampler_route,
    packed_starts,
    sample_grid,
    sampler_route,
    voxel_coords,
)

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parent.parent
BOUND = np.array([[-1.0, 1.0], [-2.0, 1.5], [0.0, 3.0]], np.float32)
# Odd Z, even Z and the prime Z = 19 of the main path's middle level; Z, Y
# and X differ, so a mix-up of the [x][y][z] and [z][y][x] corner orders
# shows.
SHAPES = [(13, 7, 9, 8), (12, 5, 6, 8), (19, 6, 11, 4)]
IDS = ["Z13", "Z12", "Z19"]


def _grid(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pts_any(n, seed):
    """Points inside, on the border of and outside the bound."""
    rng = np.random.default_rng(seed)
    lo, hi = BOUND[:, 0], BOUND[:, 1]
    ext = hi - lo
    pts = rng.uniform(lo - 0.2 * ext, hi + 0.2 * ext, size=(n, 3))
    pts[:8] = lo
    pts[8:16] = hi
    pts[16:24, 0] = hi[0]
    return pts.astype(np.float32)


def _pts_interior(n, seed, shape):
    """Interior points away from lattice planes."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape[:3]
    v = np.stack([rng.uniform(0.1, d - 1.1, n) + 0.01 for d in (nx, ny, nz)], -1)
    n01 = v / (np.array([nx, ny, nz], np.float32) - 1)
    return (BOUND[:, 0] + n01 * (BOUND[:, 1] - BOUND[:, 0])).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _packed_sample(grid, pts):
    with sampler_route("packed"):
        return sample_grid(grid, pts, _t(BOUND))


def _jax_starts(shape, pts):
    """The JAX route's int32 start rows, x-pair starts and weights."""
    vz, vy, vx = jtri.voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    idx, idx4, w = jpal._corner_indices(shape[:3], vz, vy, vx)
    return np.asarray(idx[:, 0]), np.asarray(idx4), np.asarray(w)


# ------------------------------------------------------------ plain kernels
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_corner_table_plain_bit_exact(shape):
    grid = _grid(shape, 0)
    got = pk.corner_table_plain(_t(grid)).numpy()
    want = np.asarray(jtri.corner_table(jnp.asarray(grid)))
    want_pallas = np.asarray(jpal.corner_table_pallas(jnp.asarray(grid), interpret=True))
    assert got.shape == (shape[0] * shape[1] * shape[2], 8 * shape[3])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    assert torch.equal(pk.corner_table(_t(grid)), _t(got))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gather_rows_plain_bit_exact(shape):
    table = np.asarray(jtri.corner_table(jnp.asarray(_grid(shape, 1))))
    idx = np.random.default_rng(2).integers(0, table.shape[0], 257).astype(np.int32)
    want = np.asarray(jpal.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(idx), tn=128, interpret=True))
    got = pk.gather_rows(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(pk.gather_rows_plain(_t(table), _t(idx)).numpy(), want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_starts_match_jax_corner_indices(shape):
    pts = _pts_any(257, 25)
    start, idx4, w = _jax_starts(shape, pts)
    row, tw = packed_starts(voxel_coords(_t(pts), _t(BOUND), shape[:3]), shape[:3])
    np.testing.assert_array_equal(row.numpy(), start)
    np.testing.assert_array_equal(pk.pair_starts(row, *shape[1:3]).numpy(), idx4)
    np.testing.assert_allclose(tw.numpy(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scatter_corners_plain_matches_pallas_and_vjp(shape):
    grid = _grid(shape, 3)
    pts = _pts_any(257, 4)
    _, idx4, w = _jax_starts(shape, pts)
    g = np.random.default_rng(5).normal(size=(257, shape[3])).astype(np.float32)
    w8 = np.asarray(jpal.corner_weights(w[:, 0], w[:, 1], w[:, 2]))
    np.testing.assert_allclose(
        pk.corner_weights(*(_t(w[:, a]) for a in range(3))).numpy(), w8,
        rtol=1e-6, atol=1e-7)
    ct8 = (w8[:, :, None] * g[:, None, :]).astype(np.float32)
    R, C = shape[0] * shape[1] * shape[2], shape[3]
    got = pk.scatter_corners(_t(idx4), _t(ct8), R).numpy()
    want = np.asarray(jpal.scatter_corners_pallas(
        jnp.asarray(idx4), jnp.asarray(ct8), R, C, tn=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The same scatter is the grid VJP of the reference sampler.
    vz, vy, vx = jtri.voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    _, vjp = jax.vjp(lambda gr: jtri.trilerp(gr, vz, vy, vx), jnp.asarray(grid))
    np.testing.assert_allclose(
        got.reshape(shape), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fixed_point_model_matches_plain_and_pallas(shape):
    """The model of K5 on the card: the same bits with the points permuted,
    and within 1e-5 of the plain version and of the Pallas kernel in
    interpret mode."""
    _, idx4, w = _jax_starts(shape, _pts_any(257, 35))
    g = np.random.default_rng(36).normal(size=(257, shape[3])).astype(np.float32)
    w8 = np.asarray(jpal.corner_weights(w[:, 0], w[:, 1], w[:, 2]))
    ct8 = (w8[:, :, None] * g[:, None, :]).astype(np.float32)
    R, C = shape[0] * shape[1] * shape[2], shape[3]
    got = fp.scatter_corners_fixed_point(_t(idx4), _t(ct8), R)
    perm = np.random.default_rng(37).permutation(257)
    assert torch.equal(fp.scatter_corners_fixed_point(_t(idx4[perm]), _t(ct8[perm]), R), got)
    want = pk.scatter_corners_plain(_t(idx4), _t(ct8), R)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(jpal.scatter_corners_pallas(
        jnp.asarray(idx4), jnp.asarray(ct8), R, C, tn=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row_owner_sources_invert_the_pair_scatter(shape):
    """K5's row-owner walk (``pair_row_sources``: bucket ``r`` gives row
    ``r`` its pairs' left rows, bucket ``r - 1`` their right rows) against
    ``index_add_`` of the pair scatter, on int64 terms, so exactly: starts
    of points on the far border and outside the grid (clipped), and pairs
    out of range, which the kernel skips."""
    R = shape[0] * shape[1] * shape[2]
    _, idx4, _ = _jax_starts(shape, _pts_any(300, 42))
    idx4 = idx4.copy()
    idx4[:6, 0], idx4[6:12, 2], idx4[12:18, 3] = -1, R - 1, R + 5
    rng = np.random.default_rng(43)
    terms = torch.from_numpy(rng.integers(-2**40, 2**40, size=(300, 8, 3)))
    s = torch.from_numpy(idx4).long().reshape(-1)  # pair p = n*4 + j
    keep = (s >= 0) & (s <= R - 2)
    pair = terms.reshape(-1, 2, 3)[keep]  # [kept pairs, x1, 3]
    want = torch.zeros((R, 3), dtype=torch.int64)
    for x1 in (0, 1):
        want.index_add_(0, s[keep] + x1, pair[:, x1])
    src, ok = fp.pair_row_sources(torch.arange(R), R)
    assert torch.equal(fp.row_owner_sum_plain(s[keep], pair, src, ok, R), want)
    assert torch.equal(
        fp.pair_terms(_t(idx4), terms.double(), R)[1].long(), pair.reshape(-1, 3))


# -------------------------------------------------- the packed sample_grid
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_packed_values_match_jax_sample_grid(shape):
    grid, pts = _grid(shape, 6), _pts_any(257, 7)
    want = np.asarray(jtri.sample_grid(jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(BOUND)))
    got = _packed_sample(_t(grid), _t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fused = sample_grid(_t(grid), _t(pts), _t(BOUND)).numpy()
    np.testing.assert_allclose(got, fused, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_packed_grads_match_jax(shape):
    grid, pts = _grid(shape, 8), _pts_interior(257, 9, shape)
    g = np.random.default_rng(10).normal(size=(257, shape[3])).astype(np.float32)

    def jax_loss(gr, p):
        return jnp.sum(jtri.sample_grid(gr, p, jnp.asarray(BOUND)) * g)

    want_g, want_p = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(pts))
    grads = {}
    for route in ("packed", "fused"):
        tg, tp = _t(grid).requires_grad_(True), _t(pts).requires_grad_(True)
        with sampler_route(route):
            torch.sum(sample_grid(tg, tp, _t(BOUND)) * _t(g)).backward()
        grads[route] = (tg.grad.numpy(), tp.grad.numpy())
    np.testing.assert_allclose(grads["packed"][0], np.asarray(want_g), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grads["packed"][1], np.asarray(want_p), rtol=2e-5, atol=2e-5)
    for a, b in zip(grads["packed"], grads["fused"]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("wrt", ["points", "grid"])
def test_packed_jacfwd_matches_jax(wrt):
    """``torch.func.jacfwd`` through PackedRows' jvp and vmap rules against
    ``jax.jacfwd`` of the reference sampler; the grid Jacobian on border
    and out-of-bound points too, the point Jacobian on interior points."""
    shape = SHAPES[2]
    grid = _grid(shape, 11)
    bj, bt = jnp.asarray(BOUND), _t(BOUND)
    if wrt == "points":
        pts = _pts_interior(16, 12, shape)
        want = jax.jacfwd(lambda p: jtri.sample_grid(jnp.asarray(grid), p, bj))(jnp.asarray(pts))
        with sampler_route("packed"):
            got = torch.func.jacfwd(lambda p: sample_grid(_t(grid), p, bt))(_t(pts))
    else:
        pts = _pts_any(24, 13)
        small = grid[:3, :4, :2, :2].copy()
        want = jax.jacfwd(lambda gr: jtri.sample_grid(gr, jnp.asarray(pts), bj))(jnp.asarray(small))
        with sampler_route("packed"):
            got = torch.func.jacfwd(lambda gr: sample_grid(gr, _t(pts), bt))(_t(small))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_packed_rows_vmap_rules():
    """Each vmap case of PackedRows against a loop over the batch."""
    shape = SHAPES[2]
    grids = _t(np.stack([_grid(shape, 20), _grid(shape, 21)]))
    v = voxel_coords(_t(_pts_any(33, 22)), _t(BOUND), shape[:3])
    starts = torch.stack([packed_starts(v + d, shape[:3])[0] for d in (0.0, 0.5)])
    loop = torch.stack([pk.packed_rows(grids[b], starts[b]) for b in range(2)])
    both = torch.func.vmap(pk.packed_rows)(grids, starts)
    grid_only = torch.func.vmap(pk.packed_rows, in_dims=(0, None))(grids, starts[0])
    start_only = torch.func.vmap(pk.packed_rows, in_dims=(None, 0))(grids[0], starts)
    assert torch.equal(both, loop)
    assert torch.equal(grid_only[1], pk.packed_rows(grids[1], starts[0]))
    assert torch.equal(start_only[1], pk.packed_rows(grids[0], starts[1]))


@pytest.mark.parametrize(
    "mode", ["backward", "jvp_grid", "jacfwd_points", "jacfwd_grid", "vmap"])
def test_compute_functions_get_tensors_with_storage(monkeypatch, mode):
    """Every call of a packed compute function, under every transform the
    port uses, receives tensors with storage (a CUDA kernel reads
    ``data_ptr()``)."""
    seen = []

    def recording(fn):
        def f(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.data_ptr()  # raises on a wrapper without storage
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return f

    for name in ("corner_table_plain", "gather_rows_plain", "scatter_corners_plain"):
        monkeypatch.setattr(pk, name, recording(getattr(pk, name)))
    shape = SHAPES[1]
    grid = _t(_grid(shape, 15))
    pts = _t(_pts_interior(33, 16, shape))
    x0 = torch.tensor([0.01, -0.02, 0.03, 1.0])
    bt = _t(BOUND)

    def moved(x):
        return pts + x[None, :3] * x[3]

    with sampler_route("packed"):
        if mode == "backward":
            gr = grid.clone().requires_grad_(True)
            sample_grid(gr, moved(x0), bt).sum().backward()
            assert seen == ["corner_table_plain", "gather_rows_plain", "scatter_corners_plain"]
            return
        if mode == "jvp_grid":
            _, got = torch.func.jvp(
                lambda gr: sample_grid(gr, pts, bt), (grid,), (torch.ones_like(grid),))
        elif mode == "jacfwd_points":
            got = torch.func.jacfwd(lambda x: sample_grid(grid, moved(x), bt))(x0)
        elif mode == "jacfwd_grid":
            small = grid[:, :, :, :2].contiguous()
            got = torch.func.jacfwd(lambda gr: sample_grid(gr, pts[:4], bt))(small)
        else:
            got = torch.func.vmap(lambda x: sample_grid(grid, moved(x), bt))(
                torch.stack([x0, 2 * x0]))
    assert torch.isfinite(got).all()
    assert seen and set(seen) == {"corner_table_plain", "gather_rows_plain"}


def test_wrappers_reject_bad_inputs():
    grid = torch.zeros((4, 4, 4, 8))
    table = pk.corner_table(grid)
    idx = torch.zeros((5,), dtype=torch.int32)
    with pytest.raises(TypeError):
        pk.corner_table(grid.double())
    with pytest.raises(ValueError):
        pk.corner_table(grid.transpose(0, 1))
    with pytest.raises(ValueError):
        pk.corner_table(grid[0])
    with pytest.raises(TypeError):
        pk.gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        pk.gather_rows(table, idx[:, None])
    with pytest.raises(ValueError):
        pk.scatter_corners(torch.zeros((5, 3), dtype=torch.int32), torch.zeros((5, 8, 8)), 64)
    with pytest.raises(ValueError):
        pk.scatter_corners(torch.zeros((5, 4), dtype=torch.int32), torch.zeros((5, 4, 8)), 64)
    # CPU tensors never touch the CUDA library or its launch counters.
    pk.reset_launches()
    pk.gather_rows(table, idx)
    pk.scatter_corners(torch.zeros((5, 4), dtype=torch.int32), torch.zeros((5, 8, 8)), 64)
    assert pk.LAUNCHES == {"corner_table": 0, "gather_rows": 0, "scatter_corners": 0}


def test_sampler_route_switch_restores_on_exit():
    assert get_sampler_route() == "fused"
    with pytest.raises(RuntimeError):
        with sampler_route("packed"):
            assert get_sampler_route() == "packed"
            with sampler_route("fused"):
                assert get_sampler_route() == "fused"
            assert get_sampler_route() == "packed"
            raise RuntimeError("inside")
    assert get_sampler_route() == "fused"
    with pytest.raises(ValueError):
        with sampler_route("pallas"):
            pass
    assert get_sampler_route() == "fused"


def test_build_names_each_library_by_its_source(monkeypatch, tmp_path):
    """One nvcc path builds both sources, each into its own library."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tk, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tk.subprocess, "run", fake_run)
    libs = [tk.build(src)[0] for src in (tk.CSRC / "trilerp.cu", pk.SRC)]
    assert [p.name.split("_")[0] for p in libs] == ["libtrilerp", "libpacked"]
    assert all(p.exists() and p.parent == tmp_path for p in libs)
    assert [c[-1] for c in calls] == [str(tk.CSRC / "trilerp.cu"), str(pk.SRC)]
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)


def test_build_digest_covers_included_headers(monkeypatch, tmp_path):
    """A library is named by its source and the headers beside it, so an
    edit of ``csrc/fixed_sum.cuh`` rebuilds both libraries."""
    import shutil

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    csrc = tmp_path / "csrc"
    shutil.copytree(tk.CSRC, csrc)
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tk, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tk.subprocess, "run", fake_run)
    srcs = (csrc / "trilerp.cu", csrc / "packed_table.cu")
    before = [tk.build(src)[0] for src in srcs]
    assert [tk.build(src)[0] for src in srcs] == before and len(calls) == 2
    header = csrc / "fixed_sum.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [tk.build(src)[0] for src in srcs]
    assert len(calls) == 4 and all(a != b for a, b in zip(after, before))


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package."""
    files = sorted((_ROOT / "niceslam_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "niceslam_tpu")]
    assert len(files) > 20 and not bad, bad


# ----------------------------------------------------- both routes end to end
def test_slam_routes_agree_on_cpu():
    """Three frames of the tiny CPU world under each route: the same poses
    within 1e-4 (each route's sums run in its own order, and three frames
    of GN and mapping carry the rounding differences along)."""
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from test_torch_slam import tiny_config

    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg,
        tracking=dataclasses.replace(cfg.tracking, iters=5),
        mapping=dataclasses.replace(cfg.mapping, iters_first=30, iters=8),
        pretrained_middle_fine=os.path.join(_ROOT, "models", "pretrained_decoders.npz"),
    )
    poses = {}
    for route in ("fused", "packed"):
        reader = SyntheticBoxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
        slam = NiceSLAM(cfg, reader=reader, seed=0, device="cpu")
        pk.reset_launches()
        with sampler_route(route):
            slam.run(3)
        poses[route] = np.stack(slam.est_c2w)
        launched = sum(pk.LAUNCHES.values())
        assert launched == 0  # CPU tensors: plain versions only
    assert np.isfinite(poses["packed"]).all()
    np.testing.assert_allclose(poses["packed"], poses["fused"], rtol=0, atol=1e-4)
