"""The port's trilinear sampler (TrilerpFunction, CPU plain versions) against
the JAX reference's production sampler ``ops/trilinear.sample_grid`` and its
Pallas kernels run in interpret mode.

Tolerances: 1e-5 on values, 2e-5 on derivatives (the grid gradient is a sum
of corner contributions taken in another order than JAX's transpose). The
bit-exact model of K2's grid gradient on the card (``ops/fixed_point.py``)
is held to 1e-5 of the float32 sums; its row-owner walk is held to the
forward scatter exactly (int64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.ops.pallas_trilerp import _corner_indices, trilerp_bwd_pallas, trilerp_vmem
from niceslam_tpu.ops.trilinear import corner_table as jax_corner_table
from niceslam_tpu.ops.trilinear import sample_grid as jax_sample_grid
from niceslam_tpu.ops.trilinear import trilerp_packed as jax_trilerp_packed
from niceslam_tpu.ops.trilinear import voxel_coords as jax_voxel_coords
from niceslam_tpu_torch.ops import fixed_point as fp
from niceslam_tpu_torch.ops import trilerp_kernels as tk
from niceslam_tpu_torch.ops.trilinear import sample_grid, voxel_coords

torch.set_num_threads(1)

BOUND = np.array([[-1.0, 1.0], [-2.0, 1.5], [0.0, 3.0]], np.float32)
SHAPES = [(13, 7, 9, 8), (12, 5, 6, 8)]  # odd and even Z


def _grid(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pts_any(n, seed):
    """Points inside, on the border of and outside the bound."""
    rng = np.random.default_rng(seed)
    lo, hi = BOUND[:, 0], BOUND[:, 1]
    ext = hi - lo
    pts = rng.uniform(lo - 0.2 * ext, hi + 0.2 * ext, size=(n, 3))
    pts[:8] = lo  # lower corner
    pts[8:16] = hi  # upper corner (weight-1 border convention)
    pts[16:24, 0] = hi[0]  # on one far face only
    return pts.astype(np.float32)


def _pts_interior(n, seed, shape):
    """Interior points away from lattice planes (the subgradient of floor and
    of the border clip is convention-dependent there)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape[:3]
    v = np.stack(
        [
            rng.uniform(0.1, d - 1.1, n) + 0.01
            for d in (nx, ny, nz)
        ],
        axis=-1,
    )
    dims = np.array([nx, ny, nz], np.float32)
    n01 = v / (dims - 1)  # in (0, 1)
    return (BOUND[:, 0] + n01 * (BOUND[:, 1] - BOUND[:, 0])).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_packed_sample_grid(shape):
    grid = _grid(shape, 0)
    pts = _pts_any(257, 1)
    want = np.asarray(jax_sample_grid(jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(BOUND)))
    got = sample_grid(_t(grid), _t(pts), _t(BOUND)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_trilerp_vmem(shape):
    grid = _grid(shape, 2)
    pts = _pts_any(257, 3)
    vz, vy, vx = jax_voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    want = np.asarray(trilerp_vmem(jnp.asarray(grid), vz, vy, vx, tn=128, interpret=True))
    v = voxel_coords(_t(pts), _t(BOUND), shape[:3])
    np.testing.assert_allclose(
        v.numpy(), np.stack([vz, vy, vx], -1), rtol=1e-6, atol=1e-6
    )
    got = tk.trilerp_fwd(_t(grid), v.contiguous())[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_and_point_grads_match_jax(shape):
    grid = _grid(shape, 4)
    pts = _pts_interior(257, 5, shape)
    g = np.random.default_rng(6).normal(size=(257, shape[3])).astype(np.float32)

    def jax_loss(gr, p):
        return jnp.sum(jax_sample_grid(gr, p, jnp.asarray(BOUND)) * g)

    want_g, want_p = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(pts))

    tg = _t(grid).requires_grad_(True)
    tp = _t(pts).requires_grad_(True)
    loss = torch.sum(sample_grid(tg, tp, _t(BOUND)) * _t(g))
    loss.backward()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_g), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_p), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_jvp_matches_jax_jvp(shape):
    grid = _grid(shape, 7)
    pts = _pts_interior(257, 8, shape)
    rng = np.random.default_rng(9)
    grid_dot = rng.normal(size=shape).astype(np.float32)
    pts_dot = rng.normal(size=pts.shape).astype(np.float32)
    bj = jnp.asarray(BOUND)

    want_out, want_dot = jax.jvp(
        lambda gr, p: jax_sample_grid(gr, p, bj),
        (jnp.asarray(grid), jnp.asarray(pts)),
        (jnp.asarray(grid_dot), jnp.asarray(pts_dot)),
    )
    bt = _t(BOUND)
    out, dot = torch.func.jvp(
        lambda gr, p: sample_grid(gr, p, bt),
        (_t(grid), _t(pts)),
        (_t(grid_dot), _t(pts_dot)),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dot.numpy(), np.asarray(want_dot), rtol=2e-5, atol=2e-5)
    # Points-only tangent (the tracker's case: the grid is a constant).
    _, dot_p = torch.func.jvp(
        lambda p: sample_grid(_t(grid), p, bt), (_t(pts),), (_t(pts_dot),)
    )
    _, want_p = jax.jvp(
        lambda p: jax_sample_grid(jnp.asarray(grid), p, bj),
        (jnp.asarray(pts),), (jnp.asarray(pts_dot),),
    )
    np.testing.assert_allclose(dot_p.numpy(), np.asarray(want_p), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("wrt", ["points", "grid"])
def test_jacfwd_through_function(wrt):
    """torch.func.jacfwd (vmap over tangents) through the Function's jvp and
    vmap rules, against jax.jacfwd of the reference sampler."""
    shape = SHAPES[0]
    grid = _grid(shape, 10)
    pts = _pts_interior(16, 11, shape)
    bj, bt = jnp.asarray(BOUND), _t(BOUND)
    if wrt == "points":
        want = jax.jacfwd(lambda p: jax_sample_grid(jnp.asarray(grid), p, bj))(
            jnp.asarray(pts)
        )
        got = torch.func.jacfwd(lambda p: sample_grid(_t(grid), p, bt))(_t(pts))
    else:
        small = grid[:3, :3, :3, :2].copy()
        want = jax.jacfwd(lambda gr: jax_sample_grid(gr, jnp.asarray(pts), bj))(
            jnp.asarray(small)
        )
        got = torch.func.jacfwd(lambda gr: sample_grid(gr, _t(pts), bt))(_t(small))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["backward", "jvp", "jacfwd_points", "jacfwd_grid", "vmap"])
def test_compute_functions_get_tensors_with_storage(monkeypatch, mode):
    """A CUDA kernel reads ``data_ptr()``, which a ``torch.func`` wrapper
    tensor does not have: every call of a compute function, under every
    transform the port uses, must receive plain tensors."""
    seen = []

    def recording(fn):
        def f(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.data_ptr()  # raises on a wrapper without storage
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return f

    monkeypatch.setattr(tk, "trilerp_fwd_plain", recording(tk.trilerp_fwd_plain))
    monkeypatch.setattr(tk, "trilerp_bwd_plain", recording(tk.trilerp_bwd_plain))
    shape = SHAPES[1]
    grid = _t(_grid(shape, 15))
    v = voxel_coords(_t(_pts_interior(33, 16, shape)), _t(BOUND), shape[:3]).contiguous()
    x0 = torch.tensor([0.1, -0.2, 0.3, 1.0])

    def moved(x):  # coordinates as a function of a small parameter vector
        return v + x[None, :3] * x[3]

    if mode == "backward":
        gr, vv = grid.clone().requires_grad_(True), v.clone().requires_grad_(True)
        tk.trilerp(gr, vv).sum().backward()
        assert seen[:2] == ["trilerp_fwd_plain", "trilerp_bwd_plain"]
        return
    if mode == "jvp":
        _, got = torch.func.jvp(lambda x: tk.trilerp(grid, moved(x)), (x0,), (torch.ones(4),))
    elif mode == "jacfwd_points":
        got = torch.func.jacfwd(lambda x: tk.trilerp(grid, moved(x)))(x0)
    elif mode == "jacfwd_grid":
        small = grid[:, :, :, :2].contiguous()
        got = torch.func.jacfwd(lambda gr: tk.trilerp(gr, v[:4].contiguous()))(small)
    else:
        got = torch.func.vmap(lambda x: tk.trilerp(grid, moved(x)))(torch.stack([x0, 2 * x0]))
    assert torch.isfinite(got).all()
    assert seen and set(seen) == {"trilerp_fwd_plain"}


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_trilerp_bwd(shape):
    """K2's plain version against the Pallas kernel it replaces, in
    interpret mode, on interior points: ``dgrid`` and ``dw``."""
    grid = _grid(shape, 17)
    pts = _pts_interior(257, 18, shape)
    g = np.random.default_rng(19).normal(size=(257, shape[3])).astype(np.float32)
    vz, vy, vx = jax_voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    idx, idx4, w = _corner_indices(shape[:3], vz, vy, vx)
    want_dgrid, want_dw = trilerp_bwd_pallas(
        jnp.asarray(grid).reshape(-1, shape[3]), idx, idx4, w, jnp.asarray(g),
        tn=128, interpret=True,
    )
    v = voxel_coords(_t(pts), _t(BOUND), shape[:3]).contiguous()
    dgrid, dv = tk.trilerp_bwd_plain(_t(grid), v, _t(g))
    np.testing.assert_allclose(
        dgrid.numpy().reshape(-1, shape[3]), np.asarray(want_dgrid), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dw), rtol=2e-5, atol=2e-5)


def test_plain_backward_matches_bwd_of_fwd_derivative():
    """K2's plain version: dgrid is the scatter of w8 (x) g, dv the contraction
    of K1's derivative output with g."""
    shape = SHAPES[1]
    grid = _t(_grid(shape, 12))
    v = voxel_coords(_t(_pts_any(257, 13)), _t(BOUND), shape[:3]).contiguous()
    g = _t(np.random.default_rng(14).normal(size=(257, shape[3])).astype(np.float32))
    dgrid, dv = tk.trilerp_bwd(grid, v, g)
    _, dvol = tk.trilerp_fwd(grid, v, deriv=True)
    np.testing.assert_allclose(dv.numpy(), (dvol * g[:, None]).sum(-1).numpy(), rtol=1e-6, atol=1e-6)
    ref = torch.func.vjp(lambda gr: tk.trilerp_fwd_plain(gr, v)[0], grid)[1](g)[0]
    np.testing.assert_allclose(dgrid.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_wrappers_reject_bad_inputs():
    grid = torch.zeros((4, 4, 4, 8))
    v = torch.zeros((5, 3))
    with pytest.raises(TypeError):
        tk.trilerp_fwd(grid.double(), v.double())
    with pytest.raises(ValueError):
        tk.trilerp_fwd(grid.transpose(0, 1), v)
    with pytest.raises(ValueError):
        tk.trilerp_fwd(grid, torch.zeros((5, 2)))
    with pytest.raises(ValueError):
        tk.trilerp_bwd(grid, v, torch.zeros((5, 7)))
    # CPU tensors never touch the CUDA library or its launch counters.
    tk.reset_launches()
    tk.trilerp_fwd(grid, v)
    assert tk.LAUNCHES == {"trilerp_fwd": 0, "trilerp_bwd": 0}
    assert not tk.FWD_TALLY


def _misaligned(shape):
    """A contiguous float32 view of ``shape`` 4 bytes off 16-byte alignment."""
    buf = torch.zeros(int(np.prod(shape)) + 4)
    off = next(k for k in range(4) if (buf.data_ptr() + 4 * k) % 16 == 4)
    return buf[off:off + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("C, aligned, want", [
    (32, True, ("vector", 8)),  # the main path: 4 points per warp
    (96, True, ("vector", 8)),  # vmap's fold of 3 tangents: 3 quads per lane
    (3, True, ("scalar", 2)),
    (6, True, ("scalar", 4)),
    (32, False, ("scalar", 32)),  # lane = channel
], ids=["C32", "C96", "C3", "C6", "C32-misaligned"])
@pytest.mark.parametrize("deriv", [False, True], ids=["out", "deriv"])
def test_fwd_variant_rule(C, aligned, want, deriv):
    """K1's variant rule (``fwd_variant``, whose choice the wrapper passes
    to the kernel's entry point) on tensors as the wrapper allocates them."""
    shape = (4, 5, 6, C)
    grid = torch.zeros(shape) if aligned else _misaligned(shape)
    assert grid.is_contiguous() and (grid.data_ptr() % 16 == 0) == aligned
    out = torch.empty((7, C))
    dout = torch.empty((7, 3, C)) if deriv else None
    got = tk.fwd_variant(C, grid.data_ptr(), out.data_ptr(),
                         dout.data_ptr() if deriv else None)
    assert got == want
    # An output off alignment takes the scalar kernel too.
    assert tk.fwd_variant(C, grid.data_ptr(), out.data_ptr() + 4)[0] == "scalar"


@pytest.mark.parametrize("C", [3, 96])
def test_plain_fwd_matches_jax_at_other_widths(C):
    """K1's plain version (the kernel's scalar variant's width C = 3, and
    C = 96, which the vector variant loops over) against ``trilerp_vmem``
    in interpret mode and the JAX ``sample_grid``; its derivative output
    against JAX's jvp of the production lerp, on interior points (1e-5)."""
    shape = (13, 7, 9, C)
    grid = _grid(shape, 50)
    pts = _pts_any(257, 51)
    vz, vy, vx = jax_voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    v = voxel_coords(_t(pts), _t(BOUND), shape[:3]).contiguous()
    out, _ = tk.trilerp_fwd_plain(_t(grid), v)
    want = np.asarray(trilerp_vmem(jnp.asarray(grid), vz, vy, vx, tn=128, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_sample_grid(jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(BOUND)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)

    pts = _pts_interior(257, 52, shape)
    vz, vy, vx = jax_voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    table = jax_corner_table(jnp.asarray(grid))
    lerp = lambda z, y, x: jax_trilerp_packed(table, shape[:3], z, y, x)  # noqa: E731
    ones, zeros = jnp.ones_like(vz), jnp.zeros_like(vz)
    want = np.stack([
        np.asarray(jax.jvp(lerp, (vz, vy, vx), t)[1])
        for t in ((ones, zeros, zeros), (zeros, ones, zeros), (zeros, zeros, ones))
    ], axis=1)
    v = voxel_coords(_t(pts), _t(BOUND), shape[:3]).contiguous()
    out, dvol = tk.trilerp_fwd_plain(_t(grid), v, deriv=True)
    assert torch.equal(out, tk.trilerp_fwd_plain(_t(grid), v)[0])
    np.testing.assert_allclose(dvol.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_fixed_point_model_matches_plain_and_pallas(shape):
    """The model of K2's dgrid on the card: the same bits with the points
    permuted, and within 1e-5 of the plain version (border and outside
    points too) and of the Pallas kernel in interpret mode (interior
    points, as above)."""
    C = shape[3]
    grid = _t(_grid(shape, 30))
    v = voxel_coords(_t(_pts_any(257, 31)), _t(BOUND), shape[:3]).contiguous()
    g = _t(np.random.default_rng(32).normal(size=(257, C)).astype(np.float32))
    got = fp.trilerp_bwd_fixed_point(grid, v, g)
    perm = torch.from_numpy(np.random.default_rng(33).permutation(257))
    assert torch.equal(fp.trilerp_bwd_fixed_point(grid, v[perm], g[perm]), got)
    want, _ = tk.trilerp_bwd_plain(grid, v, g, need_dv=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    pts = _pts_interior(257, 34, shape)
    vz, vy, vx = jax_voxel_coords(jnp.asarray(pts), jnp.asarray(BOUND), shape[:3])
    idx, idx4, w = _corner_indices(shape[:3], vz, vy, vx)
    want_pallas, _ = trilerp_bwd_pallas(
        jnp.asarray(grid.numpy()).reshape(-1, C), idx, idx4, w, jnp.asarray(g.numpy()),
        tn=128, interpret=True,
    )
    v = voxel_coords(_t(pts), _t(BOUND), shape[:3]).contiguous()
    got = fp.trilerp_bwd_fixed_point(grid, v, g)
    np.testing.assert_allclose(
        got.numpy().reshape(-1, C), np.asarray(want_pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape3", [(13, 7, 9), (12, 5, 6), (19, 6, 11)], ids=["Z13", "Z12", "Z19"])
def test_row_owner_sources_invert_the_corner_scatter(shape3):
    """K2's row-owner walk (``trilerp_row_sources``, which the kernel
    follows) against ``index_add_`` of the corner scatter, on int64 terms,
    so exactly: grids whose Z, Y and X differ, points on the far border and
    outside the grid (clipped starts). Without the ``z >= z1, y >= y1,
    x >= x1`` rule a row would take buckets that are not its starts."""
    Z, Y, X = shape3
    R, n = Z * Y * X, 300
    rng = np.random.default_rng(40)
    v = rng.uniform(-1.5, np.array(shape3) + 0.5, size=(n, 3))
    v[:20] = np.array(shape3) - 1  # the far corner
    v[20:40, 0], v[40:60, 1], v[60:80, 2] = Z - 1, Y - 1, X - 1  # far faces
    v[80:90] = 0.0
    rows, _ = fp.corner_terms(shape3, _t(v.astype(np.float32)), torch.zeros((n, 1)))
    terms = torch.from_numpy(rng.integers(-2**40, 2**40, size=(n, 8, 3)))
    want = torch.zeros((R, 3), dtype=torch.int64).index_add_(
        0, rows.reshape(-1), terms.reshape(-1, 3))
    src, ok = fp.trilerp_row_sources(torch.arange(R), shape3)
    assert torch.equal(fp.row_owner_sum_plain(rows[:, 0], terms, src, ok, R), want)
    assert not torch.equal(
        fp.row_owner_sum_plain(rows[:, 0], terms, src, torch.ones_like(ok), R), want)
