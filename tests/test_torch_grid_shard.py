"""The port's Z-sharded halo sampler (``niceslam_tpu_torch/grid/shard.py``)
on spawned gloo ranks, against the JAX package's ``sample_grid_sharded`` and
against the port's unsharded ``sample_grid``, on both sampler routes.

One spawn per world (2 and 4 ranks, ``map`` = world) runs every route's
case; each test reads one case's results. The JAX side runs here, in the
parent, on the suite's virtual CPU devices. The points include the two edge
cases of the design: points at ``vz == nz - 1`` (the global start clips to
``nz - 2``) and points whose start row is block 0's first row (the row that
the last rank receives as its wrap-around halo, which must send nothing
back).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.grid.shard import sample_grid_sharded as jsample_sharded
from niceslam_tpu.grid.shard import shard_grid as jshard_grid
from niceslam_tpu.parallel.mesh import make_map_mesh
from niceslam_tpu_torch.grid.shard import pad_z_to
from niceslam_tpu_torch.ops.trilinear import sample_grid, sampler_route

from torch_ranks import run_ranks

torch.set_num_threads(1)

NZ, NY, NX, C = 13, 7, 9, 8  # Z divides neither 2 nor 4
BOUND = np.array([[-1.0, 1.0], [-0.5, 0.5], [-2.0, 2.0]], np.float32)
WORLDS = (2, 4)
ROUTES = ("fused", "packed")
N_EDGE = 16  # the first points: z on the far border, then on block 0's row 0


def _inputs():
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(NZ, NY, NX, C)).astype(np.float32)
    pts = rng.uniform(-2.5, 2.5, size=(512, 3)).astype(np.float32)  # some beyond
    pts[:8, 2] = BOUND[2, 1]  # vz == NZ - 1 exactly
    pts[8:N_EDGE, 2] = BOUND[2, 0] + 0.1 * (BOUND[2, 1] - BOUND[2, 0]) / (NZ - 1)
    ct = rng.normal(size=(512, C)).astype(np.float32)
    return grid, pts, ct


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    grid, pts, ct = _inputs()
    out = {}
    for n in WORLDS:
        jobs = [("halo", n, 1, dict(grid=grid, bound=BOUND, pts=pts, ct=ct, route=r))
                for r in ROUTES]
        res = run_ranks(n, jobs, tmp_path_factory.mktemp(f"halo{n}"))
        for r, per_rank in zip(ROUTES, res):
            out[n, r] = per_rank
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """JAX ``sample_grid_sharded`` on ``n`` virtual devices: values and the
    gradients of ``sum(out * ct)`` for the zero-padded grid and the points."""
    grid, pts, ct = _inputs()
    out = {}
    for n in WORLDS:
        mesh = make_map_mesh(n)

        def loss(g, p):
            y = jsample_sharded(g, p, jnp.asarray(BOUND), mesh, nz_logical=NZ)
            return jnp.sum(y * ct), y

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        (_, y), (dg, dp) = fn(jshard_grid(jnp.asarray(grid), mesh), jnp.asarray(pts))
        out[n] = (np.asarray(y), np.asarray(dg), np.asarray(dp))
    return out


def _unsharded(route):
    grid, pts, ct = _inputs()
    g = torch.from_numpy(grid).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    with sampler_route(route):
        y = sample_grid(g, p, torch.from_numpy(BOUND))
    torch.sum(y * torch.from_numpy(ct)).backward()
    return y.detach().numpy(), g.grad.numpy(), p.grad.numpy()


def _blocks_to_grid(per_rank):
    return np.concatenate([r["d_block"] for r in sorted(per_rank, key=lambda r: int(r["map_i"]))])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", WORLDS)
def test_halo_forward_matches_unsharded_and_jax(runs, jax_ref, n, route):
    """Every rank holds the whole sample: bit for bit the unsharded one
    (the owner's value plus zeros), and the JAX value within 1e-6."""
    want, _, _ = _unsharded(route)
    for r in runs[n, route]:
        np.testing.assert_array_equal(r["out"], want)
        np.testing.assert_allclose(r["out"], jax_ref[n][0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", WORLDS)
def test_halo_backward_matches_unsharded_and_jax(runs, jax_ref, n, route):
    """The blocks' gradients, assembled, are the unsharded grid gradient
    (2e-5) with exactly zero on the padding rows; every rank's point
    gradient is the unsharded one (2e-5), the same on every rank. Against
    JAX the point gradients are compared off the far z border, where JAX's
    clip gives half the derivative (its max/min split ties) and PyTorch's
    clamp the whole one."""
    _, want_g, want_p = _unsharded(route)
    got = _blocks_to_grid(runs[n, route])
    assert got.shape[0] == pad_z_to(torch.zeros(NZ), n).shape[0]
    np.testing.assert_array_equal(got[NZ:], 0.0)
    np.testing.assert_allclose(got[:NZ], want_g, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, jax_ref[n][1], rtol=0, atol=2e-5)
    ranks = runs[n, route]
    for r in ranks:
        np.testing.assert_array_equal(r["d_pts"], ranks[0]["d_pts"])
    np.testing.assert_allclose(ranks[0]["d_pts"], want_p, rtol=0, atol=2e-5)
    np.testing.assert_allclose(ranks[0]["d_pts"][8:], jax_ref[n][2][8:], rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_halo_edge_cases(runs, n):
    """``vz == nz - 1``: value and both gradients as unsharded bit for bit
    or within 2e-5 (the local clip is the global one). Block 0's first row,
    which the last rank receives as its wrap-around halo: its gradient is
    the unsharded one, so the wrap-around sent nothing."""
    _, want_g, want_p = _unsharded("fused")
    ranks = runs[n, "fused"]
    got = _blocks_to_grid(ranks)
    assert np.abs(want_p[:8, 2]).max() > 0  # the border points do have a z gradient
    np.testing.assert_allclose(ranks[0]["d_pts"][:N_EDGE], want_p[:N_EDGE], rtol=0, atol=2e-5)
    assert np.abs(want_g[0]).max() > 0
    np.testing.assert_allclose(got[0], want_g[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[NZ - 1], want_g[NZ - 1], rtol=0, atol=2e-5)
