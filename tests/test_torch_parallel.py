"""The port's multi-rank runtime on the CPU: the sharded mapping program on
spawned gloo ranks against the port unsharded and against the JAX package's
``make_sharded_run_schedule`` on the same injected draws, the runtime's
errors, the tracker/mapper role split and the coarse stage expert on
``[cpu, cpu]`` (bit for bit against the plain run), and the command line on
two ranks with a checkpoint, a resume and a restore at another ``map``.

On a ``(1, 2)`` mesh also the system's kf-sharded mapping program against
the eager sharded pass on both sampler routes, and a runtime-attached
``NiceSLAM`` through its programs (and after ``precompile``) against the
eager runtime path, strict and async, bit for bit. On ``(2, 1)`` and
``(2, 2)`` (with the TV term) the system's map-sharded mapping program
(its segments between a fixed set of collectives) against the eager
sharded pass, the port unsharded and the JAX program on both routes, with
the collectives of an iteration counted; on ``(2, 1)`` the system through
its programs and after ``precompile`` as on ``(1, 2)``. The map cases run
again at ``rendering.N_importance = IMP`` (the importance pass: one more
segment and collective an iteration), and so does the system on
``(2, 1)``; the tiny system attaches on both meshes with it. The
importance cases run with the free-space term (``FS``), and every port
run of them takes the importance samples that the JAX program drew
(``torch_ranks.forced_importance``) after drawing its own, which are
compared on their own: the importance pass is not continuous in the
weights (``tests/test_torch_importance.py``), so runs that round apart
place a few rows' samples a bin apart, and a supervised sample that moved
changes the pass by more than the tolerances.

One spawn per world (2 ranks: ``(map, kf) = (2, 1), (1, 2)``, the kf
program, the map program and the system on both meshes; 4 ranks:
``(2, 2)`` with the TV term and its map program) from a module-scoped
fixture; each case is its own test on the fixture's results. The JAX side
runs here on the suite's virtual CPU devices, once per mesh shape.
"""
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.config.schema import MappingConfig as JMappingConfig
from niceslam_tpu.core.rays import Intrinsics as JIntrinsics
from niceslam_tpu.grid.hierarchy import GridConfig as JGridConfig
from niceslam_tpu.grid.hierarchy import init_grids as jinit_grids
from niceslam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from niceslam_tpu.models.decoders import init_decoders as jinit_decoders
from niceslam_tpu.parallel.sharded_mapper import make_sharded_run_schedule as jmake_sharded
from niceslam_tpu.parallel.sharded_mapper import make_slam_mesh_2d as jmesh_2d
from niceslam_tpu.parallel.sharded_mapper import pad_grid_for_sharding as jpad
from niceslam_tpu.render import renderer as jrenderer
from niceslam_tpu.render.renderer import RenderConfig as JRenderConfig
from niceslam_tpu.slam import mapper as jmapper
from niceslam_tpu_torch import convert
from niceslam_tpu_torch.config.schema import (
    MappingConfig,
    ParallelConfig,
    load_config,
)
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.models.decoders import tree_leaves
from niceslam_tpu_torch.parallel.mesh import MapKfMesh
from niceslam_tpu_torch.parallel.runtime import MapKfRuntime, setup_runtime
from niceslam_tpu_torch.parallel.sharded_mapper import pad_grid_for_sharding
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.slam import mapper
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.utils.checkpoint import save_checkpoint

from test_torch_run_loop import _tiny_yaml
from test_torch_slam import tiny_config
from torch_ranks import Drawn, forced_importance, run_ranks

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JINTR = JIntrinsics(H=24, W=32, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
JRCFG = JRenderConfig(n_samples=8, n_surface=4)
# Four iterations: middle, middle, fine, color. Adam makes the mapping pass
# sensitive to rounding: on this world two unsharded runs that differ only in
# the order of the TV sum part by ~1e-2 after eight iterations (a lr of 0.1
# on random grids), so a longer pass would test the rounding, not the program.
N_PIXELS, ITERS, TV = 64, 4, 0.05
# rendering.N_importance of the importance cases, and their free-space
# weight: the importance pass puts samples where the first pass's weights
# are ~1e-5, and without the free-space term the grid cells that only they
# reach get gradients at Adam's eps (1e-8), whose steps then follow the
# rounding: the port and the JAX program, with the same samples, part past
# the tolerances after the four iterations. The free-space term supervises
# every sample's occupancy, so every such cell gets a gradient that Adam
# steps alike.
IMP, FS = 4, 1.0
# (n_map, n_kf, tv_weight, n_importance); the world of each is n_map * n_kf
# ranks.
CASES = ((2, 1, 0.0, 0), (1, 2, 0.0, 0), (2, 2, TV, 0), (2, 1, 0.0, IMP), (2, 2, TV, IMP))
IDS = [f"map{m}-kf{k}{'-tv' if tv else ''}{'-imp' if imp else ''}" for m, k, tv, imp in CASES]
# The cases with more than one map block: the map-sharded program's.
MAP_CASES = tuple(c for c in CASES if c[0] > 1)
MAP_IDS = [i for c, i in zip(CASES, IDS) if c[0] > 1]
ROUTES = ("fused", "packed")
SYNCS = ("strict", "async")
SLAM_FRAMES = 5


def _world():
    """The JAX suite's sharded-mapping world (its grids padded for map = 2,
    which every case divides) with BA on the middle frame, every decoder
    trained and random frustum masks; the draws of each iteration from the
    JAX program's key."""
    bound = np.array([[-2.0, 2.0]] * 3, np.float32)
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    grids, bounds, sb = jinit_grids(kg, bound, JGridConfig(
        coarse_len=1.0, middle_len=0.5, fine_len=0.25, color_len=0.25,
        bound_divisable=0.25))
    for lvl in grids:
        grids[lvl], bounds[lvl] = jpad(grids[lvl], bounds[lvl], 2)
    dec = jinit_decoders(kd, JDecoderConfig())
    F = 3
    colors = jax.random.uniform(jax.random.PRNGKey(7), (F, JINTR.H, JINTR.W, 3))
    depths = jnp.full((F, JINTR.H, JINTR.W), 1.2)
    cams = jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0.3], jnp.float32), (F, 1))
    masks = {lvl: (jax.random.uniform(jax.random.PRNGKey(8), g.shape[:3] + (1,)) > 0.2)
             .astype(g.dtype) for lvl, g in grids.items()}
    valid = np.array([True, True, False])
    fixed = np.array([True, False, True])
    key = jax.random.PRNGKey(11)
    pixels = {}
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    for it in range(ITERS):
        kf_key, kj, ki = jax.random.split(jax.random.fold_in(key, it), 3)
        fidx = jax.random.categorical(kf_key, logits, shape=(N_PIXELS,))
        j = jax.random.randint(kj, (N_PIXELS,), 0, JINTR.H)
        i = jax.random.randint(ki, (N_PIXELS,), 0, JINTR.W)
        pixels[it] = tuple(np.asarray(a, np.int64) for a in (fidx, i, j))
    np_tree = jax.tree_util.tree_map(np.asarray, dict(
        grids=grids, bounds=bounds, scene_bound=sb, decoders=dec, colors=colors,
        depths=depths, cams=cams, masks=masks))
    return dict(np_tree, valid=valid, fixed=fixed, key=key, pixels=pixels)


def _port_args(w, tv, imp=0):
    plan = mapper.build_stage_plan(ITERS, 0.4, 0.6, MappingConfig().stage_lr)
    mcfg = mapper.MapOptConfig(BA=True, train_all_decoders=True, lr_factor=1.0)
    jplan = jmapper.build_stage_plan(ITERS, 0.4, 0.6, JMappingConfig().stage_lr)
    jmcfg = jmapper.MapOptConfig(BA=True, train_all_decoders=True, lr_factor=1.0)
    dec_train = jmapper.dec_train_from_plan(jplan, jmcfg)
    pcfg = mapper.ProgConfig(n_pixels=N_PIXELS, w_color_loss=0.2, frustum=True,
                             dec_train=dec_train, ba=True, tv_weight=tv,
                             fs_weight=FS if imp else 0.0)
    return dict(
        grids=w["grids"], masks=w["masks"], decoders=w["decoders"], cams=w["cams"],
        bounds=w["bounds"], scene_bound=w["scene_bound"], intr=Intrinsics(*JINTR),
        colors=w["colors"], depths=w["depths"], valid=w["valid"], fixed=w["fixed"],
        pcfg=pcfg, rcfg=RenderConfig(*JRCFG)._replace(n_importance=imp),
        sched=mapper.schedule_arrays(plan, mcfg),
        pixels=w["pixels"],
    ), (jplan, jmcfg, dec_train)


@pytest.fixture(scope="module")
def world():
    return _world()


def _kf_program_args(world, route):
    """A staged pass of every stage and a coarse pass, with the TV term, on
    ``route``, for ``kf_program_job`` (rows in chunks of 3)."""
    a, _ = _port_args(world, TV)
    stage_lr = MappingConfig().stage_lr
    mcfg = mapper.MapOptConfig(BA=True, train_all_decoders=True, lr_factor=1.0)
    a.update(route=route, chunk=3, plans={
        "staged": (mapper.build_stage_plan(ITERS, 0.4, 0.6, stage_lr), mcfg),
        "coarse": (mapper.build_stage_plan(2, 0.4, 0.6, stage_lr, coarse=True), mcfg)})
    return a


def _map_program_args(world, tv, imp, route):
    """``(2, *)``'s staged pass (middle, middle, fine, color; BA) on
    ``route`` for ``map_program_job``."""
    a, _ = _port_args(world, tv, imp)
    a["route"] = route
    return a


def _slam_cfg(n_map=1, imp=0):
    """The programs suite's tiny system (``configs/cofusion.yaml``: coarse
    pass, BA, color refinement) on two ranks, on kf (48 rays a row) or with
    ``n_map = 2`` on map, with ``imp`` importance samples a ray."""
    from test_torch_programs import CONFIG, TINY

    return load_config(CONFIG, overrides={**TINY, "parallel.n_processes": 2,
                                          "parallel.map": n_map,
                                          "rendering.N_importance": imp})


def _jax_args(w, tv, imp):
    """The JAX mapping program's arguments for ``_port_args``' pass."""
    _, (jplan, jmcfg, dec_train) = _port_args(w, tv, imp)
    pcfg = jmapper.ProgConfig(n_pixels=N_PIXELS, w_color_loss=0.2, frustum=True,
                              ba=True, dec_train=dec_train, tv_weight=tv,
                              fs_weight=FS if imp else 0.0)
    grids = {lvl: jnp.asarray(g) for lvl, g in w["grids"].items()}
    dec = jax.tree_util.tree_map(jnp.asarray, w["decoders"])
    cams = jnp.asarray(w["cams"])
    return (grids, dec, cams, jax.tree_util.tree_map(jnp.asarray, w["masks"]),
            jax.tree_util.tree_map(jnp.asarray, w["bounds"]),
            jnp.asarray(w["scene_bound"]), JINTR, jnp.asarray(w["colors"]),
            jnp.asarray(w["depths"]), jnp.asarray(w["valid"]), jnp.asarray(w["fixed"]),
            w["key"], jmapper.schedule_arrays(jplan, jmcfg),
            jmapper.init_opt_state({"grids": grids, "decoders": dec, "cams": cams}),
            pcfg, JRCFG._replace(n_importance=imp))


def _jax_result(g, d, c, lo):
    res = {"loss": np.asarray(lo), "cams": np.asarray(c)}
    res.update({f"grid/{lvl}": np.asarray(v) for lvl, v in g.items()})
    res.update({f"dec/{n}": np.asarray(x) for n, x in enumerate(jax.tree_util.tree_leaves(d))})
    return res


@pytest.fixture(scope="module")
def jax_importance(world):
    """``{tv: (result, table)}``: the JAX package's unsharded mapping program
    (``slam/mapper.run_schedule``) at ``N_importance = IMP``, and the
    importance samples it drew in each iteration, ``[N_PIXELS, IMP]``,
    recorded by a callback around its ``sample_pdf`` (installed for this
    trace only; the program is traced afresh). These samples place every
    port run of the importance cases (``torch_ranks.forced_importance``)."""
    out = {}
    orig = jrenderer.sampling.sample_pdf
    for tv in sorted({c[2] for c in CASES if c[3]}):
        table = []

        def recorded(bins, weights, n_samples, key=None):
            z = orig(bins, weights, n_samples, key)
            jax.debug.callback(lambda a: table.append(np.asarray(a)), z)
            return z

        jrenderer.sampling.sample_pdf = recorded
        try:
            fresh = jax.jit(jmapper.run_schedule.__wrapped__,
                            static_argnames=("intr", "pcfg", "rcfg"))
            g, d, c, _, lo = fresh(*_jax_args(world, tv, IMP))
            jax.block_until_ready(lo)
        finally:
            jrenderer.sampling.sample_pdf = orig
        assert len(table) == ITERS and table[0].shape == (N_PIXELS, IMP)
        out[tv] = (_jax_result(g, d, c, lo), table)
    return out


@pytest.fixture(scope="module")
def spawned(world, jax_importance, tmp_path_factory):
    """``out[job][rank]`` for one spawn per world: the sharded mapping pass
    of each case (``out[case]``) and, with more than one map block, the
    map-sharded program against it on each route (``out["map_program",
    case, route]``); on 2 ranks also the kf-sharded program against the
    eager pass on each route (``out["kf_program", route]``) and the
    runtime-attached system on (1, 2) and (2, 1) (``out["slam"]``,
    ``out["slam", 2]``), the system at ``rendering.N_importance = IMP`` on
    (2, 1) in strict sync (``out["slam", 2, IMP]``) and, through its
    programs only for 2 frames, on both meshes (``out["attach", m, k]``).
    The importance cases place their samples by the JAX program's."""
    out = {}

    def forced(a, tv, imp):
        return dict(a, forced=jax_importance[tv][1] if imp else None)

    for n in (2, 4):
        cases = [c for c in CASES if c[0] * c[1] == n]
        jobs = [("mapping", m, k, forced(_port_args(world, tv, imp)[0], tv, imp))
                for m, k, tv, imp in cases]
        names = list(cases)
        for case in (c for c in cases if c in MAP_CASES):
            jobs += [("map_program", case[0], case[1],
                      forced(_map_program_args(world, case[2], case[3], r), *case[2:]))
                     for r in ROUTES]
            names += [("map_program", case, r) for r in ROUTES]
        if n == 2:
            jobs += [("kf_program", 1, 2, _kf_program_args(world, r)) for r in ROUTES]
            names += [("kf_program", r) for r in ROUTES]
            jobs.append(("slam", 1, 2, dict(cfg=_slam_cfg(), frames=SLAM_FRAMES, seed=3,
                                            syncs=SYNCS)))
            names.append("slam")
            jobs.append(("slam", 2, 1, dict(cfg=_slam_cfg(2), frames=SLAM_FRAMES, seed=3,
                                            syncs=SYNCS)))
            names.append(("slam", 2))
            jobs.append(("slam", 2, 1, dict(cfg=_slam_cfg(2, IMP), frames=SLAM_FRAMES,
                                            seed=3, syncs=("strict",))))
            names.append(("slam", 2, IMP))
            jobs += [("slam", m, k, dict(cfg=_slam_cfg(m, IMP), frames=2, seed=3,
                                         syncs=("async",), eager=False))
                     for m, k in ((2, 1), (1, 2))]
            names += [("attach", 2, 1), ("attach", 1, 2)]
        out.update(zip(names, run_ranks(n, jobs, tmp_path_factory.mktemp(f"map{n}"))))
    return out


@pytest.fixture(scope="module")
def sharded(spawned):
    """``out[case][rank]``: every rank's losses, assembled grids, decoder
    leaves and cameras."""
    return {c: spawned[c] for c in CASES}


def _unsharded(world, tv, imp, table=None):
    """The port's unsharded pass; with ``table`` its importance samples
    placed by it (``forced_importance``), its own in ``own`` and their last
    two bin edges in ``edges``."""
    a, _ = _port_args(world, tv, imp)
    t = lambda x: convert.to_torch(x, "cpu")  # noqa: E731
    pp = mapper.make_pass_params(t(a["grids"]), t(a["decoders"]), t(a["cams"]), a["pcfg"])
    opt = mapper.init_opt_state(pp)
    pixels = {it: tuple(torch.from_numpy(x) for x in d) for it, d in a["pixels"].items()}
    with (forced_importance(table) if table is not None
          else contextlib.nullcontext(Drawn())) as own:
        losses = mapper.run_schedule(
            pp, opt, a["sched"], t(a["masks"]), t(a["bounds"]), t(a["scene_bound"]),
            a["intr"], t(a["colors"]), t(a["depths"]), a["valid"], a["fixed"], a["pcfg"],
            a["rcfg"], pixels=pixels)
    out = {"loss": losses.numpy(), "cams": pp.params["cams"].detach().numpy(),
           "own": np.stack([z.numpy() for z in own]) if own else np.zeros((0,)),
           "edges": np.stack([e.numpy() for e in own.edges]) if own else np.zeros((0,))}
    out.update({f"grid/{k}": v.detach().numpy() for k, v in pp.params["grids"].items()})
    out.update({f"dec/{n}": x.detach().numpy()
                for n, x in enumerate(tree_leaves(pp.params["decoders"]))})
    return out


@pytest.fixture(scope="module")
def unsharded(world, jax_importance):
    return {(tv, imp): _unsharded(world, tv, imp, jax_importance[tv][1] if imp else None)
            for _, _, tv, imp in CASES}


@pytest.fixture(scope="module")
def jax_sharded(world):
    """JAX ``make_sharded_run_schedule`` on each case's mesh."""
    out = {}
    for m, k, tv, imp in CASES:
        g, d, c, _, lo = jmake_sharded(jmesh_2d(m, k))(*_jax_args(world, tv, imp))
        out[m, k, tv, imp] = _jax_result(g, d, c, lo)
    return out


def _jax_reference(case, jax_sharded, jax_importance):
    """What a case is held to in JAX: the sharded program, or with
    ``N_importance`` the unsharded one, whose importance samples place the
    port's runs (the JAX sharded program departs from its unsharded one
    there: ``test_jax_sharded_program_with_importance_against_jax_unsharded``)."""
    return jax_importance[case[2]][0] if case[3] else jax_sharded[case]


def _hold(got, want, what, loss_tol=(2e-4, 2e-4), tol=(0.0, 2e-5)):
    """Losses and every parameter within ``(rtol, atol)``."""
    np.testing.assert_allclose(got["loss"], want["loss"], *loss_tol, err_msg=what)
    for key in want:
        if key.startswith(("grid/", "dec/")) or key == "cams":
            np.testing.assert_allclose(got[key], want[key], *tol, err_msg=f"{what}: {key}")


def test_pad_grid_for_sharding_matches_jax(world):
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(7, 6, 5, 8)).astype(np.float32)
    bound = np.array([[-1.0, 1.0], [-1.5, 1.0], [-1.0, 1.3]], np.float32)
    for n_map in (1, 2, 4):
        jg, jb = jpad(jnp.asarray(grid), jnp.asarray(bound), n_map)
        g, b = pad_grid_for_sharding(torch.from_numpy(grid), torch.from_numpy(bound), n_map)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_run_schedule_matches_unsharded(sharded, unsharded, case):
    """Sharded against the port unsharded on the same draws: losses within
    2e-4, grids, decoders and cameras within 2e-5, and every rank holds the
    same result bit for bit. The TV term is live where it is on. With
    ``N_importance`` the first point set's collectives run forward only:
    the loss sees that set through its detached weights."""
    ranks = sharded[case]
    want = unsharded[case[2:]]
    _ranks_agree(ranks)
    _hold(ranks[0], want, f"{case} vs the port unsharded")
    if case[2]:  # the TV term is live: it adds to the first loss
        assert want["loss"][0] > unsharded[0.0, case[3]]["loss"][0]
    if case[3]:  # the importance samples are live: they change the loss
        assert want["loss"][0] != unsharded[case[2], 0]["loss"][0]


def test_sharded_forward_is_bit_equal_with_one_kf_rank(sharded, unsharded):
    """With kf = 1 the first forward is the unsharded one bit for bit: the
    local z coordinate ``vz - lo`` is exact, and the map all_reduce adds
    zeros to the owner's features."""
    assert sharded[CASES[0]][0]["loss"][0] == unsharded[0.0, 0]["loss"][0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_run_schedule_matches_jax(sharded, jax_sharded, jax_importance, case):
    """Against the JAX sharded program on the same draws: losses at the
    tolerance the JAX suite holds its own sharded program to (rtol 2e-4,
    atol 1e-5, ``tests/distributed/test_sharded_full_mapping.py``),
    parameters within 1e-4. The port's *unsharded* program is as far from
    the JAX one on this world (up to 7.7e-5 on a few decoder weights of
    magnitude 0.26 after four Adam steps: the two frameworks round apart and
    Adam amplifies it), so this bound is the frameworks' gap; the sharding
    itself is held to 2e-5 against the port unsharded above. With
    ``N_importance``, against the JAX unsharded program, whose importance
    samples place the port's (``jax_importance``)."""
    _hold(sharded[case][0], _jax_reference(case, jax_sharded, jax_importance),
          f"{case} vs JAX", loss_tol=(2e-4, 1e-5), tol=(0.0, 1e-4))


# ------------------------------------------------- the kf-sharded program
def _ranks_agree(ranks):
    """Every rank's result equals rank 0's bit for bit, but the importance
    samples of their own ray slices and those samples' bin edges (``own``,
    ``edges``)."""
    for r in ranks[1:]:
        for key in ranks[0]:
            if not key.startswith(("own", "edges")):
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("route", ROUTES)
def test_kf_program_equals_the_eager_sharded_pass(spawned, route):
    """On a 1 x 2 mesh, a staged pass of every stage and then a coarse pass
    through one kf-sharded ``MappingProgram`` (capture off: the body that a
    card replays as two graphs around the all_reduce) equal
    ``rt.run_schedule`` in chunks, bit for bit: losses, grids, decoders and
    cameras, on every rank, on both sampler routes."""
    ranks = spawned["kf_program", route]
    _ranks_agree(ranks)
    got = ranks[0]
    program = [k for k in got if "/program/" in k]
    assert len(program) == len([k for k in got if "/eager/" in k]) > 8
    for key in program:
        np.testing.assert_array_equal(got[key], got[key.replace("/program/", "/eager/")],
                                      err_msg=key)
    for which, n in (("staged", ITERS), ("coarse", 2)):
        assert got[f"{which}/program/loss"].shape == (n,)
        assert np.isfinite(got[f"{which}/program/loss"]).all()
    # The coarse pass trained the coarse grid, which the staged pass leaves.
    assert not np.array_equal(got["coarse/program/grid/coarse"],
                              got["staged/program/grid/coarse"])


@pytest.mark.parametrize("sync", SYNCS)
def test_runtime_system_through_programs_equals_the_eager_runtime_path(spawned, sync):
    """A ``NiceSLAM`` on a 1 x 2 mesh (capture off) through its programs,
    the pose solve in ``TrackProgram`` and every pass in the kf-sharded
    program, gives the trajectory and grids of the eager runtime path
    (``track_frame`` and ``rt.run_schedule`` per chunk) bit for bit, on
    every rank, in strict and async sync."""
    ranks = spawned["slam"]
    _ranks_agree(ranks)
    got = ranks[0]
    keys = [k for k in got if k.startswith(f"programs/{sync}/")
            and k.split("/")[2] in ("poses", "grid")]
    assert len(keys) == 5
    for key in keys:
        np.testing.assert_array_equal(got[key], got[key.replace("programs/", "eager/", 1)],
                                      err_msg=key)
    poses = got[f"programs/{sync}/poses"]
    assert poses.shape == (SLAM_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert int(got[f"programs/{sync}/map_events"]) > SLAM_FRAMES
    assert int(got[f"programs/{sync}/tracking_programs"]) == 1
    assert int(got[f"programs/{sync}/mapping_programs"]) >= 2  # the window and refinement


def test_precompile_under_a_runtime_draws_nothing(spawned):
    """``precompile()`` on a 1 x 2 mesh makes the solve's program, the
    keyframe programs and the kf-sharded mapping program of every JAX
    signature, draws nothing from the system's generator, issues no
    collective, and leaves the trajectory and grids as they were."""
    got = spawned["slam"][0]
    assert not got["precompile/drew"]
    assert int(got["precompile/collectives"]) == 0
    assert int(got["precompile/tracking"]) == 1
    cfg = _slam_cfg()
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=2), device="cpu")
    assert [tuple(s) for s in got["precompile/mapping"].tolist()] == sorted(
        slam._precompile_signatures())
    assert bool(got["precompile/mapping_kf"])
    assert list(got["precompile/static"]) == ["frustum_masks", "keyframe_overlap"]
    for key in [k for k in got if k.startswith("precompiled/")]:
        np.testing.assert_array_equal(
            got[key], got[key.replace("precompiled/", "programs/", 1)], err_msg=key)


# ------------------------------------------------ the map-sharded program
def _kind(got, kind):
    """One side of a ``map_program_job`` result, keyed as ``mapping_job``'s."""
    return {k[len(kind) + 1:]: v for k, v in got.items() if k.startswith(kind + "/")}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", MAP_CASES, ids=MAP_IDS)
def test_map_program_matches_the_eager_sharded_pass(spawned, unsharded, case, route):
    """The system's map-sharded ``MappingProgram`` (capture off: the
    segment bodies that a card replays as graphs around the collectives)
    against ``rt.run_schedule``, the eager sharded pass whose collectives
    sit inside the halo sampler, on the same draws with BA, on both sampler
    routes, and against the port unsharded: at the tolerances of
    ``test_sharded_run_schedule_matches_unsharded`` (losses 2e-4, grids,
    decoders and cameras 2e-5); every rank holds the same result bit for
    bit. The program adds the cameras' two gradient terms, and the halo
    row's gradient to the block's own, in another order than autograd.
    With ``N_importance`` the program's importance segment places the
    merged depths that its gradient segment evaluates: the eager pass
    computes them from the same summed features inside ``render_rays``."""
    ranks = spawned["map_program", case, route]
    _ranks_agree(ranks)
    program = _kind(ranks[0], "program")
    assert np.isfinite(program["loss"]).all() and program["loss"].shape == (ITERS,)
    _hold(program, _kind(ranks[0], "eager"), f"{case} {route}: program vs eager")
    _hold(program, unsharded[case[2:]], f"{case} {route}: program vs the port unsharded")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", MAP_CASES, ids=MAP_IDS)
def test_map_program_matches_jax(spawned, jax_sharded, jax_importance, case, route):
    """The map-sharded program against the JAX sharded program on the same
    draws (with ``N_importance`` the JAX unsharded one), at
    ``test_sharded_run_schedule_matches_jax``'s tolerances."""
    _hold(_kind(spawned["map_program", case, route][0], "program"),
          _jax_reference(case, jax_sharded, jax_importance),
          f"{case} {route}: program vs JAX", loss_tol=(2e-4, 1e-5), tol=(0.0, 1e-4))


@pytest.mark.parametrize("case", MAP_CASES, ids=MAP_IDS)
def test_map_program_collectives_per_iteration(spawned, case):
    """An iteration of the map-sharded program makes the collectives of its
    segment plan, the same for every stage however many levels it samples:
    3 with one kf rank, 4 with two, and one more with ``N_importance``
    (``parallel/mesh.CALLS``). The eager pass makes up to four per sampled
    level and point set, three per TV level, and the kf sum."""
    want = 3 + (case[1] > 1) + (case[3] > 0)
    for route in ROUTES:
        got = spawned["map_program", case, route][0]
        assert got["plan/collectives"].tolist() == [want], route
        assert float(got["program/collectives"]) == want, route
        assert float(got["eager/collectives"]) > want, route


IMP_CASES = tuple(c for c in CASES if c[3])
IMP_IDS = [i for c, i in zip(CASES, IDS) if c[3]]


# The share of rows whose own last importance sample may lie more than 1e-4
# from the JAX program's in an iteration: on these inputs at most 12 of 64
# (unsharded and 2 x 1) and 7 of a rank's 32 (2 x 2) in the second
# iteration, none in the first.
MOVED_SHARE = 1 / 4


def _moved(own, edges, want, what):
    """Per iteration, the rows of ``own`` more than 1e-4 from ``want``; such
    a row differs only in its last sample (``u = 1``), which lies between
    the row's last two bin edges (``edges``) in both, and there are at most
    ``MOVED_SHARE`` of the rows."""
    far = np.abs(own - want) > 1e-4
    assert not far[..., :-1].any(), f"{what}: a sample other than the last moved"
    rows = far[..., -1]
    lo, hi = edges[..., 0] - 1e-4, edges[..., 1] + 1e-4
    for z in (own[..., -1], want[..., -1]):
        assert ((z >= lo) & (z <= hi))[rows].all(), f"{what}: outside the last bin"
    counts = rows.sum(-1).tolist()
    assert max(counts) <= MOVED_SHARE * rows.shape[-1], f"{what}: {counts}"
    return counts


@pytest.mark.parametrize("case", IMP_CASES, ids=IMP_IDS)
def test_importance_cases_draw_their_own_samples(spawned, unsharded, jax_importance, case):
    """Every port run of an importance case drew its own importance samples
    in each of the ``ITERS`` iterations (the eager sharded pass inside
    ``render_rays``, the program in its importance segment, the port
    unsharded) before it took the JAX program's. In the first iteration,
    where every run starts from the same parameters, the program's own
    samples are the eager sharded pass's bit for bit, on both routes and
    every rank, and no run's lies more than 1e-4 from the JAX program's;
    the map group's ranks draw the same bits in every iteration. In every
    iteration a run's own samples differ from the JAX program's only where
    the ``u = 1`` sample flips (``_moved``)."""
    n_kf = case[1]
    n = N_PIXELS // n_kf
    table = np.stack(jax_importance[case[2]][1])
    got = unsharded[case[2:]]
    assert got["own"].shape == (ITERS, N_PIXELS, IMP)
    moved = {"unsharded": _moved(got["own"], got["edges"], table, "unsharded")}
    for r, ranks in enumerate(spawned[case]):
        lo = (r % n_kf) * n
        what = f"sharded rank {r}"
        moved[what] = _moved(ranks["own"], ranks["edges"], table[:, lo:lo + n], what)
    for route in ROUTES:
        got = spawned["map_program", case, route]
        for r, ranks in enumerate(got):
            lo = (r % n_kf) * n
            prog, eager = ranks["own/program"], ranks["own/eager"]
            assert prog.shape == eager.shape == (ITERS, n, IMP), (route, r)
            np.testing.assert_array_equal(prog[0], eager[0], err_msg=f"{route} rank {r}")
            peer = got[r % n_kf]  # the rank of map block 0 with this kf slice
            np.testing.assert_array_equal(prog, peer["own/program"], err_msg=f"{route} {r}")
            for kind in ("program", "eager"):
                what = f"{route} {kind} rank {r}"
                moved[what] = _moved(ranks[f"own/{kind}"], ranks[f"edges/{kind}"],
                                     table[:, lo:lo + n], what)
    assert all(m[0] == 0 for m in moved.values()), moved
    print(case, "rows moved from the JAX samples, per iteration:", moved)


@pytest.mark.parametrize("case", IMP_CASES, ids=IMP_IDS)
def test_jax_sharded_program_with_importance_against_jax_unsharded(
        jax_sharded, jax_importance, case):
    """The JAX package's sharded program at ``N_importance`` against its
    unsharded one, each placing its own importance samples (what the
    port's importance cases are held to). With one kf rank and no TV term
    the two agree over the whole pass at the JAX suite's tolerances (losses
    rtol 2e-4 / atol 1e-5, grids 1e-4). On ``(2, 2)`` with the TV term only
    the first loss does: the two sum the TV term in another order, a few
    rows' importance samples move a bin in the second iteration, the
    free-space term supervises them, and a later loss parts by more than
    the tolerance (up to 0.8 on these inputs; ROADMAP queue 3). So the
    port's importance cases are held to the unsharded program, on its
    samples; once this test fails on ``(2, 2)``, they can be held to the
    sharded one."""
    got, want = jax_sharded[case], jax_importance[case[2]][0]
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], 2e-4, 1e-5)
    losses_close = np.allclose(got["loss"], want["loss"], 2e-4, 1e-5)
    grids_close = all(np.allclose(got[k], want[k], 0.0, 1e-4)
                      for k in want if k.startswith("grid/"))
    diffs = {k: float(np.abs(got[k] - want[k]).max()) for k in want if k.startswith("grid/")}
    print(case, "JAX sharded vs unsharded: losses", got["loss"].tolist(), want["loss"].tolist(),
          "grids max diff:", diffs)
    if case[1] == 1:
        assert losses_close and grids_close, diffs
    else:
        assert not losses_close


@pytest.mark.parametrize("sync", SYNCS)
def test_runtime_system_at_map_2_through_programs_equals_the_eager_runtime_path(spawned, sync):
    """A ``NiceSLAM`` on a 2 x 1 mesh (capture off) through its programs,
    every pass in the map-sharded program on the rank's Z blocks, gives the
    trajectory and grids of the eager runtime path (``rt.run_schedule`` per
    chunk, the collectives inside the halo sampler) bit for bit, on every
    rank, in strict and async sync. Bit for bit here, not only within the
    program's tolerance: no pass of these frames runs BA or the TV term,
    and every sum over the map group has two terms."""
    ranks = spawned["slam", 2]
    _ranks_agree(ranks)
    got = ranks[0]
    keys = [k for k in got if k.startswith(f"programs/{sync}/")
            and k.split("/")[2] in ("poses", "grid")]
    assert len(keys) == 5
    for key in keys:
        np.testing.assert_array_equal(got[key], got[key.replace("programs/", "eager/", 1)],
                                      err_msg=key)
    poses = got[f"programs/{sync}/poses"]
    assert poses.shape == (SLAM_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert int(got[f"programs/{sync}/map_events"]) > SLAM_FRAMES
    assert int(got[f"programs/{sync}/mapping_programs"]) >= 2


def test_precompile_at_map_2_draws_nothing_and_runs_no_collective(spawned):
    """``precompile()`` on a 2 x 1 mesh makes the map-sharded program of
    every JAX signature on the rank's blocks, draws nothing, issues no
    collective, and leaves the trajectory and grids as they were."""
    got = spawned["slam", 2][0]
    assert not got["precompile/drew"]
    assert int(got["precompile/collectives"]) == 0
    cfg = _slam_cfg(2)
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=2), device="cpu")
    assert [tuple(s) for s in got["precompile/mapping"].tolist()] == sorted(
        slam._precompile_signatures())
    assert bool(got["precompile/mapping_kf"])
    for key in [k for k in got if k.startswith("precompiled/")]:
        np.testing.assert_array_equal(
            got[key], got[key.replace("precompiled/", "programs/", 1)], err_msg=key)


def test_runtime_system_at_map_2_with_importance_equals_the_eager_runtime_path(spawned):
    """A ``NiceSLAM`` at ``rendering.N_importance = IMP`` on a 2 x 1 mesh
    (capture off) through its programs, every pass in the map-sharded
    program with its importance segment, gives the trajectory and grids of
    the eager runtime path bit for bit, on every rank; ``precompile()``
    draws nothing, issues no collective and changes nothing."""
    ranks = spawned["slam", 2, IMP]
    _ranks_agree(ranks)
    got = ranks[0]
    keys = [k for k in got if k.startswith("programs/strict/")
            and k.split("/")[2] in ("poses", "grid")]
    assert len(keys) == 5
    for key in keys:
        np.testing.assert_array_equal(got[key], got[key.replace("programs/", "eager/", 1)],
                                      err_msg=key)
    poses = got["programs/strict/poses"]
    assert poses.shape == (SLAM_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert int(got["programs/strict/map_events"]) > SLAM_FRAMES
    assert not got["precompile/drew"]
    assert int(got["precompile/collectives"]) == 0
    for key in [k for k in got if k.startswith("precompiled/")]:
        np.testing.assert_array_equal(
            got[key], got[key.replace("precompiled/", "programs/", 1)], err_msg=key)
    # The importance samples are live: the plain system maps another grid.
    plain = spawned["slam", 2][0]
    assert not np.array_equal(got["programs/strict/grid/fine"],
                              plain["programs/strict/grid/fine"])


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["map2-kf1", "map1-kf2"])
def test_runtime_attaches_n_importance_on_both_meshes(spawned, mesh):
    """``rendering.N_importance > 0`` attaches on a map mesh and on a kf
    mesh, and the system runs two frames through its programs there, every
    rank on the same trajectory."""
    ranks = spawned[("attach",) + mesh]
    _ranks_agree(ranks)
    got = ranks[0]
    assert got["programs/async/poses"].shape == (2, 4, 4)
    assert np.isfinite(got["programs/async/poses"]).all()
    assert int(got["programs/async/map_events"]) >= 2
    assert int(got["programs/async/mapping_programs"]) >= 1


# ---------------------------------------------------------------- runtime
def test_runtime_refuses_what_does_not_fit(monkeypatch):
    """A missing process id, a mesh that does not fit the world and a pixel
    budget that kf does not divide raise before any rendezvous."""
    cfg = tiny_config()
    monkeypatch.delenv("NICESLAM_PROCESS_ID", raising=False)
    par = lambda **kw: dataclasses.replace(cfg, parallel=ParallelConfig(**kw))  # noqa: E731
    with pytest.raises(ValueError, match="--process-id or NICESLAM_PROCESS_ID"):
        setup_runtime(par(n_processes=2, map=2), cpu=True)
    with pytest.raises(ValueError, match="map \\* kf must equal"):
        setup_runtime(par(n_processes=2, map=3, kf=1), process_id=0, cpu=True)
    with pytest.raises(ValueError, match="map \\* kf must equal"):
        setup_runtime(par(map=2), cpu=True)
    odd = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, pixels=255),
                              parallel=ParallelConfig(n_processes=2, kf=2))
    with pytest.raises(ValueError, match="must divide the kf mesh axis"):
        setup_runtime(odd, process_id=0, cpu=True)
    monkeypatch.setenv("NICESLAM_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="not below n_processes"):
        setup_runtime(par(n_processes=2, map=2), cpu=True)
    rt = setup_runtime(cfg, cpu=True)
    assert rt.trivial and rt.world == 1


def test_multihost_configs_load_and_build():
    """``configs/apartment_multihost.yaml`` and a map = 2 block load into
    ``NiceSLAM``, which accepts any ``parallel`` block."""
    path = os.path.join(_ROOT, "configs", "apartment_multihost.yaml")
    for overrides in (None, {"parallel.map": 2, "parallel.n_processes": 2}):
        par = load_config(path, overrides=overrides).parallel
        cfg = dataclasses.replace(tiny_config(), parallel=par)
        NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=2), device="cpu")


def test_attach_and_restore_pad_to_the_map_axis(tmp_path):
    """Attaching a map = 2 runtime pads every grid (edge rows, extended z
    bound, as ``pad_grid_for_sharding``) and the observed-voxel counts; a
    checkpoint written unpadded (map = 1) is padded again on restore, and
    the padded snapshot restores unchanged. No collective is needed."""
    cfg = dataclasses.replace(tiny_config(gt_camera=True), mapping=dataclasses.replace(
        tiny_config().mapping, iters_first=4, lock_after=3))
    reader = SyntheticBoxReader(cfg, n_frames=2)
    plain = NiceSLAM(cfg, reader=reader, device="cpu")
    plain.n_imgs = 2
    plain.step(reader[0])
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, plain.state, plain.est_c2w, plain.gt_c2w, 0,
                    bounds=plain.bounds, scene_bound=plain.scene_bound)
    rt = MapKfRuntime(MapKfMesh(2, 1, 0, 0), "cpu", None)
    fresh = NiceSLAM(cfg, reader=reader, device="cpu")
    for src in (fresh, plain):  # attached; then restored from plain's checkpoint
        slam = NiceSLAM(cfg, reader=reader, device="cpu")
        rt.attach(slam)
        if src is plain:
            slam.restore(ck)
        assert slam.events[0]["event"] == "runtime" and slam._runtime is rt
        for lvl, g in src.state.grids.items():
            want_g, want_b = pad_grid_for_sharding(g, src.bounds[lvl], 2)
            assert torch.equal(slam.state.grids[lvl], want_g), lvl
            assert torch.equal(slam.bounds[lvl], want_b), lvl
            assert slam._obs_counts[lvl].shape[:3] == want_g.shape[:3]
    padded = str(tmp_path / "ck_padded")
    save_checkpoint(padded, slam.state, slam.est_c2w, slam.gt_c2w, 0,
                    bounds=slam.bounds, scene_bound=slam.scene_bound)
    again = NiceSLAM(cfg, reader=reader, device="cpu")
    rt.attach(again)
    again.restore(padded)
    for lvl in slam.state.grids:
        assert torch.equal(again.state.grids[lvl], slam.state.grids[lvl])
        assert torch.equal(again.bounds[lvl], slam.bounds[lvl])


# ----------------------------------------------------------------- roles
def _role_cfg(**parallel):
    parallel = dict(parallel)
    cfg = tiny_config(gt_camera="stage_ep" in parallel)
    return dataclasses.replace(
        cfg, cam=dataclasses.replace(cfg.cam, H=24, W=32, fx=20.0, fy=20.0, cx=16.0, cy=12.0),
        tracking=dataclasses.replace(cfg.tracking, pixels=64, iters=4,
                                     ignore_edge_H=2, ignore_edge_W=2),
        mapping=dataclasses.replace(cfg.mapping, pixels=128, iters_first=8, iters=6,
                                    every_frame=2, mapping_window_size=3, max_keyframes=8),
        rendering=dataclasses.replace(cfg.rendering, N_samples=8, N_surface=4),
        coarse="stage_ep" in parallel, verbose=False,
        sync_method=parallel.pop("sync"), parallel=ParallelConfig(**parallel))


@pytest.mark.parametrize("roles", [
    dict(track_role=True, sync="async"),
    dict(stage_ep=True, sync="strict"),
    dict(stage_ep=True, track_role=True, sync="async"),
], ids=["track_role-async", "stage_ep-strict", "both-async"])
def test_roles_on_two_devices_equal_the_plain_run(roles):
    """``track_role`` and ``stage_ep`` on ``[cpu, cpu]``: the same poses,
    grids and decoders as the plain run, bit for bit."""
    runs = []
    split_cfg = _role_cfg(**roles)
    for cfg in (dataclasses.replace(split_cfg, parallel=ParallelConfig()), split_cfg):
        slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=6), seed=3,
                        devices=["cpu", "cpu"])
        slam.run(6)
        runs.append(slam)
    plain, split = runs
    assert (split._track_device() is not None) == ("track_role" in roles)
    assert (split._expert_device() is not None) == ("stage_ep" in roles)
    np.testing.assert_array_equal(np.stack(split.est_c2w), np.stack(plain.est_c2w))
    for lvl in plain.state.grids:
        assert torch.equal(split.state.grids[lvl], plain.state.grids[lvl]), lvl
    for a, b in zip(tree_leaves(split.state.decoders), tree_leaves(plain.state.decoders)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- CLI
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli(cfg_path, out, world, n_map, frames, extra=(), deadline_s=240.0):
    """``python -m niceslam_tpu_torch`` on ``world`` CPU ranks; returns rank
    0's last stdout line. The ranks are killed at the deadline."""
    port = _free_port()
    common = [sys.executable, "-m", "niceslam_tpu_torch", cfg_path, "--cpu",
              "--frames", str(frames), "--set", "sync_method=async",
              "--set", "tracking.method=adam", "--set", f"parallel.n_processes={world}",
              "--set", f"parallel.map={n_map}", "--set", f"parallel.coordinator=localhost:{port}",
              "--ckpt-dir", str(out / "ck"), "--log", str(out / "metrics.jsonl"),
              "--trajectory", str(out / "traj.npy"), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_ROOT)
    procs = [subprocess.Popen(common + ["--process-id", str(r)], cwd=_ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    t_end = time.monotonic() + deadline_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(t_end - time.monotonic(), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_cli_two_ranks_checkpoint_resume_and_restore_at_another_map(tmp_path):
    """Two ranks (map = 2, async) for 3 frames with a checkpoint every
    frame: rank 0 alone writes and prints, the ranks end on the same
    trajectory (the command checks it), the first event of a rank's log is
    the runtime and the last its programs (eager on the CPU); a resume from frame 1 on two ranks in strict sync, and a
    restore of the same padded checkpoint on one rank (map = 1), continue
    from the restored poses."""
    cfg_path = _tiny_yaml(tmp_path)
    a = tmp_path / "a"
    last = _cli(cfg_path, a, 2, 2, 3)
    assert last["frames"] == 3 and last["ate_rmse_cm"] < 20.0
    traj = np.load(a / "traj.npy")
    assert traj.shape == (3, 4, 4) and np.isfinite(traj).all()
    assert sorted(os.listdir(a / "ck")) == ["frame_000001", "frame_000002"]
    logs = {r: [json.loads(x) for x in (a / n).read_text().splitlines()]
            for r, n in ((0, "metrics.jsonl"), (1, "metrics.rank1.jsonl"))}
    for r, recs in logs.items():
        assert recs[0]["event"] == "runtime" and recs[0]["rank"] == r
        assert recs[0]["backend"] == "gloo" and (recs[0]["map"], recs[0]["kf"]) == (2, 1)
        # On the CPU the programs run eagerly: no graph is captured.
        progs = {k: recs[-1].get(k) for k in ("event", "graphed", "graphs", "map_segments")}
        assert progs == {"event": "programs", "graphed": False, "graphs": {},
                         "map_segments": []}
    saved = torch.load(a / "ck" / "frame_000001", weights_only=True)
    assert all(g.shape[0] % 2 == 0 for g in saved["grids"].values())

    for world, n_map in ((2, 2), (1, 1)):
        b = tmp_path / f"b{world}"
        last = _cli(cfg_path, b, world, n_map, 3,
                    extra=["--resume", str(a / "ck" / "frame_000001"),
                           "--set", "sync_method=strict"])
        got = np.load(b / "traj.npy")
        assert last["frames"] == 3 and got.shape == (3, 4, 4) and np.isfinite(got).all()
        np.testing.assert_array_equal(got[:2], traj[:2])
