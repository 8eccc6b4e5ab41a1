"""The port's core modules (pose, rays, sampling, compositing, grid hierarchy,
ATE, synthetic scene) against the JAX package's functions on shared numpy
inputs. Tolerance 1e-5 unless a line says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.config.schema import SLAMConfig as JSLAMConfig
from niceslam_tpu.core import compositing as jcomp
from niceslam_tpu.core import pose as jpose
from niceslam_tpu.core import rays as jrays
from niceslam_tpu.core import sampling as jsamp
from niceslam_tpu.eval import ate as jate
from niceslam_tpu.grid import hierarchy as jhier
from niceslam_tpu.io.datasets import synthetic as jsyn
from niceslam_tpu_torch.config.schema import SLAMConfig
from niceslam_tpu_torch.core import compositing, pose, rays, sampling
from niceslam_tpu_torch.eval import ate
from niceslam_tpu_torch.grid import hierarchy
from niceslam_tpu_torch.io.datasets import synthetic

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), **(kw or TOL),
    )


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = [0.0, 1.0, 0.0, 0.0]  # 180-degree rotation (w == 0)
    q[1] = [1.0, 0.0, 0.0, 0.0]  # identity
    return q


def test_quaternion_rotation_round_trip():
    q = _rotations(64, 0)
    R_want = jpose.quat_to_rotation(jnp.asarray(q))
    R = pose.quat_to_rotation(_t(q))
    _close(R, R_want)
    _close(pose.rotation_to_quat(R), jpose.rotation_to_quat(R_want))
    # w >= 0 canonicalization, with w == -0.0 kept on the +w branch
    q_back = pose.rotation_to_quat(R).numpy()
    assert (q_back[:, 0] >= 0).all()


def test_camera_tensor_packing_and_inverse():
    rng = np.random.default_rng(1)
    cam = np.concatenate(
        [_rotations(16, 2), rng.normal(size=(16, 3)).astype(np.float32)], -1
    )
    c34 = pose.camera_from_tensor(_t(cam))
    _close(c34, jpose.camera_from_tensor(jnp.asarray(cam)))
    c44 = pose.to_homogeneous(c34)
    _close(c44, jpose.to_homogeneous(jpose.camera_from_tensor(jnp.asarray(cam))))
    _close(pose.tensor_from_camera(c44), jpose.tensor_from_camera(jnp.asarray(c44.numpy())))
    _close(pose.invert_pose(c44), jpose.invert_pose(jnp.asarray(c44.numpy())))


def test_to_homogeneous_fills_the_row_as_before():
    """The bottom row is filled on the tensor's device (no copy from the
    host): the same values as the tensor the host used to copy, for one
    pose, a batch of them, and under ``jacfwd`` and autograd."""
    cam = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32)
    c34 = pose.camera_from_tensor(_t(cam))

    def before(c):
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c.dtype).expand(c.shape[:-2] + (1, 4))
        return torch.cat([c, bottom], dim=-2)

    for c in (c34, c34[0]):
        assert torch.equal(pose.to_homogeneous(c), before(c))
    x = _t(cam[0])
    J = torch.func.jacfwd(lambda q: pose.to_homogeneous(pose.camera_from_tensor(q)))(x)
    assert torch.equal(J, torch.func.jacfwd(lambda q: before(pose.camera_from_tensor(q)))(x))
    xg = x.clone().requires_grad_(True)
    pose.to_homogeneous(pose.camera_from_tensor(xg)).sum().backward()
    assert torch.equal(xg.grad, torch.func.grad(
        lambda q: before(pose.camera_from_tensor(q)).sum())(x))


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.5])
def test_se3_exp_incl_taylor_branch(scale):
    rng = np.random.default_rng(3)
    xi = (rng.normal(size=6) * scale).astype(np.float32)
    xi[3:] = rng.normal(size=3)
    _close(pose.se3_exp(_t(xi)), jpose.se3_exp(jnp.asarray(xi)))
    # forward-mode derivative at the twist (the tracker linearizes at 0)
    J = torch.func.jacfwd(pose.se3_exp)(_t(xi))
    J_want = jax.jacfwd(jpose.se3_exp)(jnp.asarray(xi))
    _close(J, J_want, rtol=1e-4, atol=1e-5)


def test_constant_speed_warm_start_with_clamps():
    rng = np.random.default_rng(4)
    for k, (ang, tr) in enumerate([(0.01, 0.02), (0.5, 0.4), (3.1, 1.0)]):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        q = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis]).astype(np.float32)
        prev2 = np.eye(4, dtype=np.float32)
        prev = np.asarray(
            jpose.to_homogeneous(
                jpose.camera_from_tensor(
                    jnp.asarray(np.concatenate([q, rng.normal(size=3) * tr]).astype(np.float32))
                )
            )
        )
        want = jpose.constant_speed_warm_start(jnp.asarray(prev), jnp.asarray(prev2))
        got = pose.constant_speed_warm_start(_t(prev), _t(prev2))
        _close(got, want, rtol=1e-5, atol=2e-5)


INTR = rays.Intrinsics(H=48, W=64, fx=40.0, fy=42.0, cx=32.0, cy=23.5)
JINTR = jrays.Intrinsics(*INTR)


def test_pixel_dirs_and_sample_rays():
    rng = np.random.default_rng(5)
    i = rng.integers(0, 64, 100)
    j = rng.integers(0, 48, 100)
    _close(
        rays.pixel_dirs(INTR, _t(i), _t(j)),
        jrays.pixel_dirs(JINTR, jnp.asarray(i, jnp.float32), jnp.asarray(j, jnp.float32)),
    )
    c2w = np.asarray(jpose.to_homogeneous(jpose.camera_from_tensor(
        jnp.asarray([0.9, 0.1, -0.3, 0.2, 0.1, -0.2, 0.3], jnp.float32))))
    depth = rng.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    color = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = rays.sample_rays(INTR, _t(c2w), _t(depth), _t(color), torch.as_tensor(i), torch.as_tensor(j))
    dirs = jrays.pixel_dirs(JINTR, jnp.asarray(i, jnp.float32), jnp.asarray(j, jnp.float32))
    _close(b.rays_d, dirs @ jnp.asarray(c2w)[:3, :3].T)
    _close(b.rays_o, np.broadcast_to(c2w[:3, 3], (100, 3)))
    _close(b.gt_depth, depth[j, i])
    _close(b.gt_color, color[j, i])


def test_draw_pixels_follows_the_generator_device(monkeypatch):
    """Without a device argument the pixels land on the generator's device,
    and without a generator on the port's default device (never the CPU
    unless asked)."""
    intr = rays.Intrinsics(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    i, j = rays.draw_pixels(torch.Generator().manual_seed(0), intr, 50, 4, 5)
    assert i.device.type == "cpu" and j.device.type == "cpu"
    assert int(j.min()) >= 4 and int(j.max()) < 44 and int(i.min()) >= 5 and int(i.max()) < 59
    want = rays.draw_pixels(torch.Generator().manual_seed(0), intr, 50, 4, 5, device="cpu")
    assert torch.equal(i, want[0]) and torch.equal(j, want[1])
    seen = []

    def fake_randint(lo, hi, size, generator=None, device=None):
        seen.append(device)
        return torch.zeros(size, dtype=torch.long)

    monkeypatch.setattr(rays.torch, "randint", fake_randint)
    rays.draw_pixels(None, intr, 3)
    assert seen == [rays.DEFAULT_DEVICE] * 2 and rays.DEFAULT_DEVICE == "cuda"


@pytest.mark.parametrize("with_depth", [True, False])
def test_near_far_from_bound(with_depth):
    rng = np.random.default_rng(6)
    o = rng.uniform(-0.5, 0.5, (50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    bound = np.array([[-2, 2], [-1.5, 2.5], [-3, 1]], np.float32)
    gt = rng.uniform(0.5, 3, 50).astype(np.float32)
    near, far = rays.near_far_from_bound(
        _t(o), _t(d), _t(bound), _t(gt) if with_depth else None, 16
    )
    jn, jf = jrays.near_far_from_bound(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(bound),
        jnp.asarray(gt) if with_depth else None, 16,
    )
    _close(near, jn)
    _close(far, jf)


def test_sampling_stratified_surface_merge_points():
    rng = np.random.default_rng(7)
    near = np.tile(rng.uniform(0.01, 0.05, (40, 1)), (1, 16)).astype(np.float32)
    far = rng.uniform(2, 4, (40, 1)).astype(np.float32)
    gt = rng.uniform(0.5, 3, 40).astype(np.float32)
    gt[:5] = 0.0  # zero-depth rows span [1e-3, max gt]
    zs = sampling.stratified_z_vals(_t(near), _t(far), 16)
    _close(zs, jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16))
    zf = sampling.surface_z_vals(_t(gt), 8, band=0.03)
    _close(zf, jsamp.surface_z_vals(jnp.asarray(gt), 8, band=0.03))
    zm = sampling.merge_z_vals(zs, zf)
    _close(zm, jsamp.merge_z_vals(jnp.asarray(zs.numpy()), jnp.asarray(zf.numpy())))
    o = rng.normal(size=(40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    _close(
        sampling.points_along_rays(_t(o), _t(d), zm),
        jsamp.points_along_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(zm.numpy())),
    )


def test_sample_pdf_deterministic():
    rng = np.random.default_rng(8)
    bins = np.sort(rng.uniform(0, 4, (30, 17)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (30, 16)).astype(np.float32)
    got = sampling.sample_pdf(_t(bins), _t(w), 12)
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12)
    _close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("occupancy", [True, False])
def test_raw_to_outputs(occupancy):
    rng = np.random.default_rng(9)
    raw = rng.normal(size=(30, 24, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 4, (30, 24)), -1).astype(np.float32)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    got = compositing.raw_to_outputs(_t(raw), _t(z), _t(d), occupancy=occupancy)
    want = jcomp.raw_to_outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), occupancy=occupancy)
    for g, w_ in zip(got[:4], want[:4]):
        _close(g, w_, rtol=1e-5, atol=2e-5)


def test_grid_hierarchy_shapes_and_bounds():
    cfg = jhier.GridConfig()
    bound = np.asarray(JSLAMConfig().bound, np.float32)
    jgrids, jbounds, jb = jhier.init_grids(jax.random.PRNGKey(0), bound, cfg)
    grids, bounds, b = hierarchy.init_grids(
        bound, hierarchy.GridConfig(*cfg), gen=torch.Generator().manual_seed(0), device="cpu"
    )
    np.testing.assert_allclose(b, jb)
    for lvl in hierarchy.LEVELS:
        assert tuple(grids[lvl].shape) == tuple(jgrids[lvl].shape), lvl
        np.testing.assert_allclose(bounds[lvl].numpy(), np.asarray(jbounds[lvl]))
        std = 1e-4 if lvl == "fine" else 0.01
        assert abs(float(grids[lvl].std()) / std - 1.0) < 0.2
    # The bench configuration's main-path shapes.
    assert tuple(grids["middle"].shape) == (19, 12, 26, 32)
    assert tuple(grids["fine"].shape) == (38, 24, 53, 32)


def test_ate_and_synthetic_scene_match():
    cfg, jcfg = SLAMConfig(), JSLAMConfig()
    poses = synthetic.circular_trajectory(6)
    for p, q in zip(poses, jsyn.circular_trajectory(6)):
        np.testing.assert_array_equal(p, q)
    intr = rays.Intrinsics(H=24, W=32, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    box = np.asarray(cfg.bound, np.float32) * 0.9
    c, d = synthetic.render_box_scene(intr, poses[2], box)
    jc, jd = jsyn.render_box_scene(jrays.Intrinsics(*intr), poses[2], box)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(d, jd)
    rng = np.random.default_rng(10)
    est = [p.copy() for p in poses]
    for p in est:
        p[:3, 3] += rng.normal(size=3) * 0.05
    assert ate.ate_rmse(est, poses) == pytest.approx(jate.ate_rmse(est, poses), rel=1e-12)
    assert jcfg.tracking.pixels == cfg.tracking.pixels
