"""Decoder pretraining in the port against the JAX package's recipe
(``scripts/pretrain_decoders.py``), on the same decoders and grids (carried
across with ``convert.py``) and the same injected point sets.

The script's loss lives inside its ``main()``, where nothing can import it,
so this file restates it in JAX (lines cited below) with the point sets as
inputs, on the JAX package's ``nice_forward`` (its default sampler route, as
the script runs) and ``optax``. Tolerances: losses 1e-5 relative, gradients
2e-5 of each leaf's largest entry (the fp32 sums of the two packages round
differently); after Adam steps, see :func:`test_replay_matches_jax`. The
step's program over static buffers equals the host loop it replaced bit for
bit (:func:`test_program_equals_the_host_loop`).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from niceslam_tpu.grid.hierarchy import GridConfig as JGridConfig
from niceslam_tpu.grid.hierarchy import adjust_bound as jadjust_bound
from niceslam_tpu.grid.hierarchy import init_grids as jinit_grids
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.models.decoders import nice_forward as jnice_forward
from niceslam_tpu.models.pretrained import load_decoders_npz as jload_npz
from niceslam_tpu.models.pretrained import save_decoders_npz as jsave_npz
from niceslam_tpu_torch import convert
from niceslam_tpu_torch import pretrain_decoders as pd
from niceslam_tpu_torch.grid.hierarchy import init_grids
from niceslam_tpu_torch.models.decoders import init_decoders, tree_leaves, tree_map
from niceslam_tpu_torch.models.pretrained import (
    _flatten_with_keys,
    load_decoders_npz,
    save_decoders_npz,
)
from niceslam_tpu_torch.slam import mapper, programs

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(_ROOT, "models", "pretrained_decoders.npz")
CFG = pd.PretrainConfig(steps=3, batch=128)
N_OBS = pd.N_OBS


# ------------------------------------------ the script, restated in JAX
def script_geometry(rng, adj_bound):
    """scripts/pretrain_decoders.py:240-261, the geometry of one scene."""
    ext = adj_bound[:, 1] - adj_bound[:, 0]
    shrink = rng.uniform(0.72, 0.95, 3)
    room_ext = ext * shrink
    slack = ext - room_ext
    room_min = adj_bound[:, 0] + rng.uniform(0, 1, 3) * slack
    room = np.stack([room_min, room_min + room_ext], -1)
    obs = []
    for _ in range(N_OBS):
        oe = room_ext * rng.uniform(0.08, 0.3, 3)
        omin = room_min + rng.uniform(0.05, 0.9, 3) * (room_ext - oe)
        obs.append(np.stack([omin, omin + oe], -1))
    return {
        "room": jnp.asarray(room, jnp.float32),
        "obs": jnp.asarray(np.stack(obs), jnp.float32),
        "palette": jnp.asarray(rng.uniform(0.15, 0.95, (6, 3)), jnp.float32),
        "obs_color": jnp.asarray(rng.uniform(0.15, 0.95, (N_OBS, 3)), jnp.float32),
    }


def _sd_box_outside(p, box):  # :106-109
    q = jnp.maximum(box[:, 0] - p, p - box[:, 1])
    return jnp.max(q, axis=-1)


def _sd_occupied(p, room, obs):  # :111-116
    sd = _sd_box_outside(p, room)
    for k in range(N_OBS):
        sd = jnp.maximum(sd, -_sd_box_outside(p, obs[k]))
    return sd


def _checker_shade(p):  # :118-120
    chk = jnp.mod(jnp.sum(jnp.floor(p / 0.5), axis=-1), 2.0)
    return 0.75 + 0.25 * chk


def script_loss(trainable, geom, batch, grid_bounds, cfg=CFG):
    """:140-211, the point sets (the script's draws, :147-158 and :174-176)
    taken from ``batch``."""
    dec, grids = trainable
    room, obs = geom["room"], geom["obs"]
    p_uni, p_room, f_room, p_obs, p_c = (
        batch[k] for k in ("p_uni", "p_room", "f_room", "p_obs", "p_c"))
    n_per = p_obs.shape[0] // N_OBS
    c_obs_list = [jnp.broadcast_to(geom["obs_color"][j], (n_per, 3)) for j in range(N_OBS)]
    pts = jnp.concatenate([p_uni, p_room, p_obs], 0)

    sd = _sd_occupied(pts, room, obs)
    t_mf = jnp.tanh(sd / cfg.width)
    occ_m = jnice_forward(dec, grids, pts, grid_bounds, "middle")[:, 3]
    occ_f = jnice_forward(dec, grids, pts, grid_bounds, "fine")[:, 3]
    loss_m = jnp.mean(optax.huber_loss(occ_m, t_mf, delta=1.0))
    loss_f = jnp.mean(optax.huber_loss(occ_f, t_mf, delta=1.0))

    t_c = jnp.tanh(_sd_occupied(p_c, room, obs) / cfg.width_coarse)
    occ_c = jnice_forward(dec, grids, p_c, grid_bounds, "coarse")[:, 3]
    loss_c = jnp.mean(optax.huber_loss(occ_c, t_c, delta=1.0))

    p_col = jnp.concatenate([p_room, p_obs], 0)
    c_room = geom["palette"][f_room]
    c_tgt = (jnp.concatenate([c_room, jnp.concatenate(c_obs_list, 0)], 0)
             * _checker_shade(p_col)[:, None])
    rgb = jnice_forward(dec, grids, p_col, grid_bounds, "color")[:, :3]
    loss_col = jnp.mean(jnp.abs(rgb - c_tgt))

    zg = jax.tree_util.tree_map(jnp.zeros_like, grids)
    p_cal = pts[:: max(len(pts) // 1024, 1)]
    cal = 0.0
    for stage in ("middle", "fine", "coarse"):
        o0 = jnice_forward(dec, zg, p_cal, grid_bounds, stage)[:, 3]
        cal = cal + jnp.mean((o0 - cfg.cal_target) ** 2)

    reg = sum(jnp.mean(g * g) for g in grids.values())
    total = loss_m + loss_f + loss_c + 0.5 * loss_col + 0.3 * cal + 1e-2 * reg
    aux = {"m": loss_m, "f": loss_f, "c": loss_c, "col": loss_col, "cal": cal}
    return total, aux


_dec_tx = optax.adam(CFG.decoders_lr)
_grid_tx = optax.adam(CFG.grids_lr)


@jax.jit
def script_step(dec, grids, dec_st, grid_st, geom, batch, grid_bounds):
    """:213-222, one jitted step; also returns the step's gradients."""
    (total, aux), grads = jax.value_and_grad(script_loss, has_aux=True)(
        (dec, grids), geom, batch, grid_bounds)
    gdec, ggrid = grads
    du, dec_st = _dec_tx.update(gdec, dec_st, dec)
    dec = optax.apply_updates(dec, du)
    gu, grid_st = _grid_tx.update(ggrid, grid_st, grids)
    grids = optax.apply_updates(grids, gu)
    return dec, grids, dec_st, grid_st, total, aux, grads


script_loss_jit = jax.jit(script_loss)


# ------------------------------------------------------------- inputs
def np_batch(rng, geom, grid_bounds, B):
    """The step's point sets, drawn with numpy as the script draws them
    with ``jax.random`` (uniform in a box; near a box's faces with Gaussian
    jitter; ``n_per`` points for each obstacle)."""
    geom = {k: np.asarray(v) for k, v in geom.items()}

    def uniform(n, box):
        box = np.asarray(box)
        return (box[:, 0] + rng.random((n, 3)) * (box[:, 1] - box[:, 0])).astype(np.float32)

    def surface(n, box, jitter):
        p = uniform(n, box)
        face = rng.integers(0, 6, n)
        p[np.arange(n), face // 2] = box[face // 2, face % 2]
        return (p + jitter * rng.normal(size=(n, 3))).astype(np.float32), face

    p_room, f_room = surface(B // 2, geom["room"], 0.06)
    n_per = max(B // (2 * N_OBS), 1)
    return {
        "p_uni": uniform(B, grid_bounds["middle"]),
        "p_room": p_room, "f_room": f_room,
        "p_obs": np.concatenate([surface(n_per, geom["obs"][j], 0.04)[0] for j in range(N_OBS)]),
        "p_c": uniform(B, grid_bounds["coarse"]),
    }


def to_port(tree):
    return convert.to_torch(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def scene(s, seed=0):
    """Scene ``s`` of a run with ``seed`` as the script builds it: JAX
    grids from ``PRNGKey(seed + 100 + s)`` on envelope ``s % 3``, and its
    geometry (the draws of scenes ``0..s`` from one numpy generator)."""
    bi = s % len(pd.BOUND_SET)
    grids, bounds, adj = jinit_grids(jax.random.PRNGKey(seed + 100 + s),
                                     np.asarray(pd.BOUND_SET[bi], np.float32), JGridConfig())
    rng = np.random.default_rng(seed)
    for k in range(s + 1):
        geom = script_geometry(rng, jadjust_bound(
            np.asarray(pd.BOUND_SET[k % 3], np.float32), JGridConfig().bound_divisable))
    return grids, bounds, geom


@pytest.fixture(scope="module")
def jdec():
    return jinit_decoders(jax.random.PRNGKey(1))


def leaf(tree, key):
    for part in key.split("/"):
        tree = tree[int(part) if isinstance(tree, (list, tuple)) else part]
    return tree


# ---------------------------------------------------------------- (a)
def test_scene_geometry_matches_script_bit_for_bit():
    """Six scenes (two per envelope) from one generator, and the port's
    adjusted bounds equal to JAX's."""
    rng_s, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    for s in range(6):
        bound = np.asarray(pd.BOUND_SET[s % 3], np.float32)
        jadj = jadjust_bound(bound, JGridConfig().bound_divisable)
        _, _, adj = init_grids(bound, device="cpu")
        np.testing.assert_array_equal(adj, np.asarray(jadj))
        want = script_geometry(rng_s, np.asarray(jadj))
        got = pd.scene_geometry(rng_p, adj)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"scene {s} {k}")


# ---------------------------------------------------------------- (b)
def _rel(got, want, tol, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{name}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def test_loss_and_grads_match_jax(jdec):
    """The smallest envelope: loss, aux terms and every gradient."""
    jgrids, jbounds, geom = scene(0)
    batch = np_batch(np.random.default_rng(7), geom, jbounds, CFG.batch)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (want, waux), (gdec, ggrid) = jax.jit(jax.value_and_grad(script_loss, has_aux=True))(
        (jdec, jgrids), geom, jb, jbounds)
    dec, grids = pd.trainable(to_port(jdec)), pd.trainable(to_port(jgrids))
    total, aux, grads = pd.loss_and_grads(dec, grids, to_port(batch), to_port(geom),
                                          to_port(jbounds), CFG)
    _rel(total.item(), want, 1e-5, "loss")
    for k in waux:
        _rel(aux[k].item(), waux[k], 1e-5, f"aux {k}")
    keys = [k for k, _ in _flatten_with_keys(dec)] + list(grids)
    assert len(keys) == len(grads) == 85
    for key, g in zip(keys, grads):
        want_g = np.asarray(ggrid[key] if key in grids else leaf(gdec, key))
        got_g = np.zeros_like(want_g) if g is None else g.numpy()
        if key.endswith("embed_B"):  # frozen inside the decoders in both packages
            assert g is None and not want_g.any(), key
            continue
        assert np.abs(want_g).max() > 0, key
        _rel(got_g, want_g, 2e-5, f"grad {key}")


@pytest.mark.parametrize("s", [1, 2])
def test_loss_matches_jax_on_the_other_envelopes(jdec, s):
    jgrids, jbounds, geom = scene(s)
    batch = np_batch(np.random.default_rng(8 + s), geom, jbounds, CFG.batch)
    want, waux = script_loss_jit((jdec, jgrids), geom, jax.tree_util.tree_map(
        jnp.asarray, batch), jbounds)
    total, aux = pd.pretrain_loss(to_port(jdec), to_port(jgrids), to_port(batch),
                                  to_port(geom), to_port(jbounds), CFG)
    _rel(total.item(), want, 1e-5, f"loss, envelope {s}")
    for k in waux:
        _rel(aux[k].item(), waux[k], 1e-5, f"aux {k}, envelope {s}")


# ---------------------------------------------------------------- (c)
def test_replay_matches_jax(jdec):
    """2 scenes x 3 steps at batch 128: the script's loop (one jitted step,
    fresh Adam moments per scene) against ``train_scene`` on the same
    draws. Losses per step within 1e-5 relative. After six Adam steps the
    decoders within 1e-5 of the largest entry of their leaf, except for at
    most 1 in 1000 elements: Adam divides by the root of the second moment,
    so an element whose gradients are near zero turns a rounding difference
    into a step of up to the learning rate (1e-3); those stay within it."""
    rng = np.random.default_rng(11)
    jd, dec = jdec, pd.trainable(to_port(jdec))
    for s in range(2):
        jgrids, jbounds, geom = scene(s)
        grids = pd.trainable(to_port(jgrids))
        batches = [np_batch(rng, geom, jbounds, CFG.batch) for _ in range(CFG.steps)]
        dec_st, grid_st = _dec_tx.init(jd), _grid_tx.init(jgrids)
        want = []
        for b in batches:
            jd, jgrids, dec_st, grid_st, total, _, _ = script_step(
                jd, jgrids, dec_st, grid_st, geom, jax.tree_util.tree_map(jnp.asarray, b),
                jbounds)
            want.append(float(total))
        losses, _ = pd.train_scene(dec, grids, to_port(geom), to_port(jbounds), CFG,
                                   batches=[to_port(b) for b in batches])
        np.testing.assert_allclose(losses.numpy(), want, rtol=1e-5)
    beyond = total_n = 0
    for key, t in _flatten_with_keys(dec):
        w = np.asarray(leaf(jd, key))
        err = np.abs(t.detach().numpy() - w)
        assert err.max() <= CFG.decoders_lr, key
        beyond += int((err > 1e-5 * max(np.abs(w).max(), 1.0)).sum())
        total_n += w.size
    assert beyond <= total_n // 1000, f"{beyond} of {total_n} elements beyond 1e-5"


# ---------------------------------------------------------------- (d)
def test_npz_round_trips_both_ways_bit_for_bit(tmp_path, jdec):
    rng = np.random.default_rng(3)
    dec = init_decoders(device="cpu")
    dec = convert.to_torch({k: v for k, v in _as_np(dec, rng).items()}, "cpu")
    port_path = str(tmp_path / "port.npz")
    save_decoders_npz(port_path, dec)
    got = jload_npz(port_path, jdec)
    for key, t in _flatten_with_keys(dec):
        np.testing.assert_array_equal(np.asarray(leaf(got, key)), t.numpy(), err_msg=key)
    jax_path = str(tmp_path / "jax.npz")
    jsave_npz(jax_path, jdec)
    back = load_decoders_npz(jax_path, init_decoders(device="cpu"))
    for key, t in _flatten_with_keys(back):
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf(jdec, key)), err_msg=key)
    shipped = set(np.load(SHIPPED).files)
    assert set(np.load(port_path).files) == shipped and len(shipped) == 81


def _as_np(dec, rng):
    """``dec``'s structure with random float32 values (nested numpy)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return rng.normal(size=tuple(t.shape)).astype(np.float32)
    return walk(dec)


# ---------------------------------------------------------------- (e)
def test_main_prints_the_script_json_last(tmp_path, capsys):
    out = str(tmp_path / "p.npz")
    assert pd.main(["--cpu", "--scenes", "3", "--steps", "2", "--batch", "64",
                    "--out", out]) == 0
    cap = capsys.readouterr()
    last = json.loads(cap.out.strip().splitlines()[-1])
    assert set(last) == {"scenes", "steps_per_scene", "final_losses", "wall_s", "out"}
    assert last["scenes"] == 3 and last["steps_per_scene"] == 2 and last["out"] == out
    assert set(last["final_losses"]) == {"m", "f", "c", "col", "cal"}
    assert len([line for line in cap.err.splitlines() if line.startswith("scene ")]) == 3
    dec = load_decoders_npz(out, init_decoders(device="cpu"))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(dec))
    jload_npz(out, jinit_decoders(jax.random.PRNGKey(0)))


def test_main_refuses_the_shipped_file_and_a_missing_card():
    with pytest.raises(ValueError, match="shipped"):
        pd.main(["--cpu", "--out", SHIPPED])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            pd.main(["--scenes", "1", "--steps", "1"])


def test_draw_batch_sizes_and_ranges():
    """The script's point counts (at B = 4096: 8,190 occupancy, 4,094
    color, 4,096 coarse, 1,170 calibration points), inside their boxes."""
    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[2], np.float32), device="cpu")
    geom = {k: torch.from_numpy(v) for k, v in
            pd.scene_geometry(np.random.default_rng(0), adj).items()}
    b = pd.draw_batch(torch.Generator().manual_seed(0), geom, bounds, 4096)
    pts = pd.occupancy_points(b)
    assert (pts.shape[0], b["p_room"].shape[0] + b["p_obs"].shape[0], b["p_c"].shape[0],
            pd.calibration_points(pts).shape[0]) == (8190, 4094, 4096, 1170)
    for name, box in (("p_uni", bounds["middle"]), ("p_c", bounds["coarse"])):
        assert bool(((b[name] >= box[:, 0]) & (b[name] <= box[:, 1])).all()), name
    # every room point lies within its jitter of the face it was put on
    axis, side = b["f_room"] // 2, b["f_room"] % 2
    on = b["p_room"].gather(1, axis[:, None])[:, 0] - geom["room"][axis, side]
    assert float(on.abs().max()) < 0.06 * 6


def test_step_launches_match_the_smoke_count(monkeypatch):
    """The sampler calls of one step, counted at the wrappers on the CPU,
    equal what ``chip_smoke.py`` phase 12 expects of K1 and K2 on the card
    (11 forward, 7 grid-gradient-only backward at B = 4096)."""
    import importlib.util
    from collections import Counter

    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    k1, k2 = Counter(), Counter()
    fwd, bwd = tk.trilerp_fwd, tk.trilerp_bwd

    def count_fwd(grid, v, deriv=False):
        k1["vector", deriv, v.shape[0]] += 1
        return fwd(grid, v, deriv)

    def count_bwd(grid, v, g, need_dgrid=True, need_dv=True):
        k2[need_dgrid, need_dv] += 1
        return bwd(grid, v, g, need_dgrid, need_dv)

    monkeypatch.setattr(tk, "trilerp_fwd", count_fwd)
    monkeypatch.setattr(tk, "trilerp_bwd", count_bwd)
    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[0], np.float32), device="cpu")
    geom = {k: torch.from_numpy(v) for k, v in
            pd.scene_geometry(np.random.default_rng(0), adj).items()}
    batch = pd.draw_batch(torch.Generator().manual_seed(0), geom, bounds, 4096)
    pd.loss_and_grads(pd.trainable(init_decoders(device="cpu")), pd.trainable(grids), batch,
                      geom, bounds, CFG)
    want_k1, want_k2 = smoke.pretrain_expected_launches(4096, 1)
    assert (k1, k2) == (want_k1, want_k2)
    assert (sum(k1.values()), sum(k2.values())) == (11, 7)


# ---------------------------------------------------------------- (f)
def _loop_train_scene(decoders, grids, geom, grid_bounds, cfg, gen=None, batches=None):
    """``train_scene`` as it was before its program: one host loop, the bias
    corrections indexed with the step's Python int, the losses in a list."""
    leaves = pd.trainable_leaves(decoders, grids)
    n_dec = len(leaves) - len(grids)
    lrs = [cfg.decoders_lr] * n_dec + [cfg.grids_lr] * len(grids)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    c1, c2 = mapper.bias_corrections(cfg.steps, "cpu")
    losses, aux = [], {}
    for step in range(cfg.steps):
        batch = (batches[step] if batches is not None
                 else pd.draw_batch(gen, geom, grid_bounds, cfg.batch))
        total, aux, grads = pd.loss_and_grads(decoders, grids, batch, geom, grid_bounds, cfg)
        with torch.no_grad():
            for p, g, m, v, lr in zip(leaves, grads, mu, nu, lrs):
                mapper.adam_moments_(m, v, g)
                p.sub_(lr * mapper.adam_direction(m, v, c1[step], c2[step]))
        losses.append(total.detach())
    return torch.stack(losses), {k: t.detach() for k, t in aux.items()}


@pytest.mark.parametrize("draws", ["generator", "batches"])
def test_program_equals_the_host_loop(draws):
    """Three scenes on envelopes 0, 1 and 0 again (its program's buffers
    reused, the moments zeroed anew) x 3 steps at batch 64, with the
    decoders carried across: the program over static buffers (capture off)
    equals the host loop it replaced in every loss, term, decoder leaf and
    grid, bit for bit, with draws from one generator per path or the same
    injected batches."""
    cfg = pd.PretrainConfig(steps=3, batch=64)
    progs = programs.Programs(capture=False)
    rng = np.random.default_rng(4)
    dec0 = init_decoders(gen=torch.Generator().manual_seed(1), device="cpu")
    decs = [pd.trainable(dec0), pd.trainable(tree_map(torch.clone, dec0))]
    gens = [torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)]
    for s, bi in enumerate((0, 1, 0)):
        grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[bi], np.float32),
                                        gen=torch.Generator().manual_seed(100 + s), device="cpu")
        geom = {k: torch.from_numpy(v) for k, v in pd.scene_geometry(rng, adj).items()}
        batches = None
        if draws == "batches":
            batches = [pd.draw_batch(torch.Generator().manual_seed(20 + 3 * s + k), geom, bounds,
                                     cfg.batch) for k in range(cfg.steps)]
        both = [pd.trainable(tree_map(torch.clone, grids)) for _ in range(2)]
        got = pd.train_scene(decs[0], both[0], geom, bounds, cfg, gens[0], batches,
                             programs=progs)
        want = _loop_train_scene(decs[1], both[1], geom, bounds, cfg, gens[1], batches)
        assert bool(torch.isfinite(got[0]).all()) and torch.equal(got[0], want[0]), s
        assert set(got[1]) == set(want[1]) and all(torch.equal(got[1][k], want[1][k])
                                                   for k in want[1]), s
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(decs[0]), tree_leaves(decs[1])))
        assert all(torch.equal(both[0][k], both[1][k]) for k in grids), s
        assert not torch.equal(both[0]["fine"], grids["fine"])  # stepped in place
    assert len(progs.pretraining) == 2 and not progs.captures
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_capture_needs_a_card():
    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[0], np.float32), device="cpu")
    geom = {k: torch.from_numpy(v) for k, v in
            pd.scene_geometry(np.random.default_rng(0), adj).items()}
    with pytest.raises(ValueError, match="capture=True needs CUDA devices"):
        pd.train_scene(pd.trainable(init_decoders(device="cpu")), pd.trainable(grids), geom,
                       bounds, CFG, torch.Generator(), capture=True)
    with pytest.raises(ValueError, match="capture=True needs CUDA devices"):
        pd.pretrain(pd.PretrainConfig(scenes=1, steps=1, batch=64), "cpu", capture=True)
