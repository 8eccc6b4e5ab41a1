"""Gloo ranks on the CPU for the port's multi-rank tests.

:func:`run_ranks` spawns one process per rank, which meet through a file in
the test's temporary directory (no port can clash between parallel test
workers) with a 60 s timeout on every collective, and run a list of jobs in
order. The parent waits with a deadline and kills the ranks when one fails
or the deadline passes, so a hung collective costs one test, not the suite.

This module imports torch, numpy and the port only: the ranks never import
JAX. The tests compute the JAX side in the parent and hand it over as numpy.
"""
from __future__ import annotations

import contextlib
import os
import traceback
from datetime import timedelta

import numpy as np
import torch

TIMEOUT_S = 60


def run_ranks(world: int, jobs, tmp, deadline_s: float = 240.0):
    """Run ``jobs`` (a list of ``(name, n_map, n_kf, payload)``) on ``world``
    spawned gloo ranks; returns ``out[job][rank]``, a dict of numpy arrays."""
    from niceslam_tpu_torch.parallel.runtime import spawn_ranks

    tmp = str(tmp)
    init = os.path.join(tmp, f"rendezvous_{world}")
    try:
        spawn_ranks(_rank_main, range(world), (world, init, jobs, tmp), deadline_s)
    except RuntimeError as e:
        errs = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f.read())
        raise RuntimeError(f"{e}\n" + "\n".join(errs)) from None
    return [
        [dict(np.load(os.path.join(tmp, f"job{k}_rank{r}.npz"))) for r in range(world)]
        for k in range(len(jobs))
    ]


def _rank_main(rank, world, init, jobs, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", world_size=world, rank=rank,
            timeout=timedelta(seconds=TIMEOUT_S),
        )
        for k, (name, n_map, n_kf, payload) in enumerate(jobs):
            out = JOBS[name](n_map, n_kf, payload)
            np.savez(os.path.join(tmp, f"job{k}_rank{rank}.npz"),
                     **{key: _np(v) for key, v in out.items()})
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _stack(ts):
    return torch.stack(ts) if ts else torch.zeros((0,))


def _t(tree):
    from niceslam_tpu_torch.convert import to_torch

    return to_torch(tree, "cpu")


class Drawn(list):
    """The importance samples a run drew, one array a call, and in
    ``edges`` each call's last two bin edges (``[N, 2]``)."""

    def __init__(self):
        super().__init__()
        self.edges = []


@contextlib.contextmanager
def forced_importance(table, start: int = 0):
    """The port's importance draws placed by ``table``: the ``k``-th call of
    ``core.sampling.sample_pdf`` (``render_rays``' importance pass, once a
    mapping iteration) returns rows ``[start, start + N)`` of ``table[k]``
    instead of its own samples, which it yields (a :class:`Drawn`). The
    importance pass is not continuous in the weights
    (``tests/test_torch_importance.py``): two programs that round apart
    place some rows' samples a bin apart, and Adam turns the tiny gradients
    at a moved sample into full steps on grid cells that nothing else
    reaches. So runs that are compared after a few iterations take one
    placement, and the tests compare their own."""
    from niceslam_tpu_torch.core import sampling

    orig = sampling.sample_pdf
    own = Drawn()

    def forced(bins, weights, n_samples, gen=None, deterministic=True):
        z = orig(bins, weights, n_samples, gen, deterministic)
        own.append(z.detach().clone())
        own.edges.append(bins[..., -2:].detach().clone())
        return torch.tensor(np.asarray(table[len(own) - 1])[start:start + z.shape[0]],
                            dtype=z.dtype, device=z.device)

    sampling.sample_pdf = forced
    try:
        yield own
    finally:
        sampling.sample_pdf = orig


def _forcing(p, n_kf):
    """:func:`forced_importance` on this rank's ray slice of ``p["forced"]``,
    or nothing without a table."""
    import torch.distributed as dist

    if p.get("forced") is None:
        return contextlib.nullcontext(Drawn())
    kf_i = dist.get_rank() % n_kf
    return forced_importance(p["forced"], kf_i * p["pcfg"].n_pixels // n_kf)


def halo_job(n_map, n_kf, p):
    """The halo sampler on this rank's block of ``p["grid"]`` (zero-padded
    to the map axis): its values, and the gradients of ``sum(out * ct)``
    for the block and the points."""
    from niceslam_tpu_torch.grid.shard import sample_grid_sharded, shard_hierarchy
    from niceslam_tpu_torch.ops.trilinear import sampler_route
    from niceslam_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_map, n_kf)
    blocks, nz = shard_hierarchy({"g": _t(p["grid"])}, mesh)
    block = blocks["g"].clone().requires_grad_(True)
    pts = _t(p["pts"]).requires_grad_(True)
    with sampler_route(p["route"]):
        out = sample_grid_sharded(block, pts, _t(p["bound"]), mesh, nz_logical=nz["g"])
        torch.sum(out * _t(p["ct"])).backward()
    return {"out": out, "d_block": block.grad, "d_pts": pts.grad,
            "map_i": mesh.map_i, "kf_i": mesh.kf_i}


def mapping_job(n_map, n_kf, p):
    """One sharded ``run_schedule`` on grids padded for ``n_map`` with the
    injected draws ``p["pixels"]`` (and with ``p["forced"]`` the importance
    samples of :func:`forced_importance`): losses, the assembled grids, the
    decoder leaves, the cameras and its own importance samples
    (``[iterations, rays, N_importance]``, empty without a table) with
    their last two bin edges (``edges``)."""
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam.mapper import init_opt_state, make_pass_params

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    grids, masks = _t(p["grids"]), _t(p["masks"])
    pp = make_pass_params(rt.split(grids), _t(p["decoders"]), _t(p["cams"]), p["pcfg"])
    opt = init_opt_state(pp)
    pixels = {it: tuple(torch.from_numpy(a).long() for a in d) for it, d in p["pixels"].items()}
    with _forcing(p, n_kf) as own:
        losses = rt.run_schedule(
            pp, opt, p["sched"], rt.split(masks), _t(p["bounds"]), _t(p["scene_bound"]),
            p["intr"], _t(p["colors"]), _t(p["depths"]), p["valid"], p["fixed"],
            p["pcfg"], p["rcfg"], pixels=pixels,
        )
    out = {"loss": losses, "cams": pp.params["cams"], "own": _stack(own),
           "edges": _stack(own.edges)}
    out.update({f"grid/{k}": v for k, v in rt.assemble(pp.params["grids"]).items()})
    out.update({f"dec/{n}": t for n, t in enumerate(tree_leaves(pp.params["decoders"]))})
    return out


def kf_program_job(n_map, n_kf, p):
    """On a mesh with one map block, a staged pass (every stage) and then a
    coarse pass of ``p``'s world through one kf-sharded ``MappingProgram``
    (capture off) and through ``rt.run_schedule`` in chunks of ``p["chunk"]``
    rows, on the route ``p["route"]``: each one's losses, grids, decoder
    leaves and cameras, keyed ``program/...`` and ``eager/...``."""
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.ops.trilinear import sampler_route
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam import mapper
    from niceslam_tpu_torch.slam.programs import Programs

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    grids, masks, dec, cams = (_t(p[k]) for k in ("grids", "masks", "decoders", "cams"))
    bounds, sb, colors, depths = (_t(p[k]) for k in ("bounds", "scene_bound", "colors",
                                                       "depths"))
    args = (p["intr"], colors, depths, p["valid"], p["fixed"], p["pcfg"], p["rcfg"])
    progs = Programs(capture=False)
    out = {}
    with sampler_route(p["route"]):
        for which, (plan, mcfg) in p["plans"].items():
            sched = mapper.schedule_arrays(plan, mcfg)
            draws = [tuple(torch.from_numpy(a).long() for a in p["pixels"][it])
                     for it in range(len(sched))]
            pp = mapper.make_pass_params(grids, dec, cams, p["pcfg"])
            opt = mapper.init_opt_state(pp)
            chunks, reals = mapper.chunked_schedule(plan, mcfg, p["chunk"])
            losses = torch.cat([
                rt.run_schedule(pp, opt, c, masks, bounds, sb, *args,
                                pixels=dict(enumerate(draws)))[:real]
                for c, real in zip(chunks, reals)])
            prog = progs.map_program((cams.shape[0], False, True), "cpu", p["pcfg"],
                                     p["intr"], p["rcfg"], grids, dec, cams, len(sched),
                                     kf=rt.kf_slice(p["pcfg"].n_pixels))
            got = prog.run(grids, dec, cams, masks, bounds, sb, colors, depths, p["valid"],
                           p["fixed"], sched, mapper.stack_draws(draws, "cpu"))
            for kind, (g, d, c, lo) in (("eager", (pp.params["grids"], pp.params["decoders"],
                                                    pp.params["cams"], losses)),
                                        ("program", got)):
                out[f"{which}/{kind}/loss"] = lo
                out[f"{which}/{kind}/cams"] = c
                out.update({f"{which}/{kind}/grid/{k}": v for k, v in g.items()})
                out.update({f"{which}/{kind}/dec/{n}": t
                            for n, t in enumerate(tree_leaves(d))})
    assert len(progs.mapping) == 1
    return out


def map_program_job(n_map, n_kf, p):
    """On a mesh with more than one map block, ``p``'s staged pass through
    the system's map-sharded ``MappingProgram`` (capture off: the segment
    bodies that a card replays as graphs) and through ``rt.run_schedule``
    (the eager sharded pass) on the same injected draws, on the route
    ``p["route"]``: each one's losses, assembled grids, decoder leaves and
    cameras (``program/...``, ``eager/...``), each one's collectives per
    row, and the collectives of the program's segment plan of every stage
    of the pass. With ``p["forced"]`` both place their importance samples
    by :func:`forced_importance` and report their own."""
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.ops.trilinear import sampler_route
    from niceslam_tpu_torch.parallel.mesh import CALLS, make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam import mapper
    from niceslam_tpu_torch.slam.programs import Programs

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    grids, masks, dec, cams = (_t(p[k]) for k in ("grids", "masks", "decoders", "cams"))
    bounds, sb, colors, depths = (_t(p[k]) for k in ("bounds", "scene_bound", "colors",
                                                       "depths"))
    sched, pcfg = p["sched"], p["pcfg"]
    rows = len(sched)
    draws = [tuple(torch.from_numpy(a).long() for a in p["pixels"][it]) for it in range(rows)]
    blocks, mblocks = rt.split(grids), rt.split(masks)
    out = {}
    with sampler_route(p["route"]):
        pp = mapper.make_pass_params(blocks, dec, cams, pcfg)
        c0 = CALLS["all_reduce"]
        with _forcing(p, n_kf) as own:
            losses = rt.run_schedule(pp, mapper.init_opt_state(pp), sched, mblocks, bounds, sb,
                                     p["intr"], colors, depths, p["valid"], p["fixed"], pcfg,
                                     p["rcfg"], pixels=dict(enumerate(draws)))
        out["own/eager"], out["edges/eager"] = _stack(own), _stack(own.edges)
        c1 = CALLS["all_reduce"]
        prog = Programs(capture=False).map_program(
            (cams.shape[0], False, True), "cpu", pcfg, p["intr"], p["rcfg"], blocks, dec, cams,
            rows, kf=rt.kf_slice(pcfg.n_pixels))
        with _forcing(p, n_kf) as own:
            got = prog.run(blocks, dec, cams, mblocks, bounds, sb, colors, depths, p["valid"],
                           p["fixed"], sched, mapper.stack_draws(draws, "cpu"))
        out["own/program"], out["edges/program"] = _stack(own), _stack(own.edges)
        c2 = CALLS["all_reduce"]
        lrs = mapper.schedule_lrs(sched)
        plans = {sum(seg.before is not None for seg in prog.plan(stage, zero))
                 for (stage, zero), _ in prog._runs(sched, lrs)}
    out.update({"eager/collectives": (c1 - c0) / rows, "program/collectives": (c2 - c1) / rows,
                "plan/collectives": sorted(plans)})
    for kind, (g, d, c, lo) in (("eager", (pp.params["grids"], pp.params["decoders"],
                                           pp.params["cams"], losses)), ("program", got)):
        out[f"{kind}/loss"] = lo
        out[f"{kind}/cams"] = c
        out.update({f"{kind}/grid/{k}": v for k, v in rt.assemble(g).items()})
        out.update({f"{kind}/dec/{n}": t for n, t in enumerate(tree_leaves(d))})
    return out


def _eager_runtime_slam():
    """``NiceSLAM`` as it ran under a runtime before its programs: the pose
    solve by ``track_frame`` on the published map, the passes by
    ``rt.run_schedule`` (the eager sharded pass, its collectives inside the
    halo sampler with ``map > 1``) per chunk of ``mapping.iters`` rows on
    this rank's Z blocks, the grids assembled after each pass."""
    import torch

    from niceslam_tpu_torch.slam import mapper
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from niceslam_tpu_torch.slam.tracker import track_frame

    class EagerRuntimeSLAM(NiceSLAM):
        def _solve(self, frame, init, td=None):
            st = self.state
            return track_frame(st.decoders, st.grids, self.bounds, self.scene_bound,
                               self.intr, frame.color, frame.depth, init, self.tcfg,
                               self.rcfg, gen=self.gen)

        def _map_pass(self, signature, plan, mcfg, pcfg, grids, masks, decoders, cams,
                      colors, depths, valid, fixed, device=None):
            rt = self._runtime
            n_total = sum(n for _, n, _ in plan)
            chunks, reals = mapper.chunked_schedule(plan, mcfg,
                                                    min(self.cfg.mapping.iters, n_total))
            pp = mapper.make_pass_params(rt.split(grids), decoders, cams, pcfg)
            opt_state = mapper.init_opt_state(pp)
            masks = rt.split(masks)
            losses = torch.cat([
                rt.run_schedule(pp, opt_state, chunk, masks, self.bounds, self.scene_bound,
                                self.intr, colors, depths, valid, fixed, pcfg, self.rcfg,
                                gen=self.gen)[:real]
                for chunk, real in zip(chunks, reals)])
            params = pp.params
            return rt.assemble(params["grids"]), params["decoders"], params["cams"], losses

    return EagerRuntimeSLAM


def slam_job(n_map, n_kf, p):
    """A runtime-attached ``NiceSLAM`` on the CPU (capture off) over
    ``p["frames"]`` frames of the synthetic scene, for each sync method of
    ``p["syncs"]``: through its programs (``programs/<sync>/...``), as the
    eager runtime path (``eager/<sync>/...``) and, for the first sync
    method, through its programs after ``precompile()`` (``precompiled/...``,
    with whether ``precompile`` moved the generator, the collectives it
    issued and the programs it made). ``p["eager"]`` false runs the
    programs only."""
    import dataclasses

    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.parallel.mesh import CALLS, make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam.system import NiceSLAM

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    out = {}
    for k, sync in enumerate(p["syncs"]):
        cfg = dataclasses.replace(p["cfg"], sync_method=sync)
        runs = [("programs", NiceSLAM)]
        if p.get("eager", True):
            runs.append(("eager", _eager_runtime_slam()))
            if k == 0:
                runs.append(("precompiled", NiceSLAM))
        for kind, cls in runs:
            slam = cls(cfg, reader=SyntheticBoxReader(cfg, n_frames=p["frames"]), seed=p["seed"],
                       device="cpu")
            rt.attach(slam)
            if kind == "precompiled":
                state = slam.gen.get_state()
                calls = CALLS["all_reduce"]
                slam.precompile()
                progs = slam._programs
                out["precompile/collectives"] = CALLS["all_reduce"] - calls
                out["precompile/drew"] = not torch.equal(slam.gen.get_state(), state)
                out["precompile/tracking"] = len(progs.tracking)
                out["precompile/mapping"] = sorted(prog.signature for prog in progs.mapping.values())
                out["precompile/mapping_kf"] = all(key[5] == rt.kf_slice(cfg.mapping.pixels).key
                                                   for key in progs.mapping)
                out["precompile/static"] = sorted(key[0].split()[0] for key in progs.static)
            res = slam.run(p["frames"])
            tag = f"{kind}/{sync}"
            out[f"{tag}/poses"] = np.stack(res["est_c2w"])
            out.update({f"{tag}/grid/{lvl}": g for lvl, g in slam.state.grids.items()})
            out[f"{tag}/map_events"] = sum(e["event"] == "map" for e in slam.events)
            if kind == "programs":
                out[f"{tag}/mapping_programs"] = len(slam._programs.mapping)
                out[f"{tag}/tracking_programs"] = len(slam._programs.tracking)
    return out


JOBS = {"halo": halo_job, "mapping": mapping_job, "kf_program": kf_program_job,
        "map_program": map_program_job, "slam": slam_job}
