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

import multiprocessing as mp
import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

TIMEOUT_S = 60


def run_ranks(world: int, jobs, tmp, deadline_s: float = 240.0):
    """Run ``jobs`` (a list of ``(name, n_map, n_kf, payload)``) on ``world``
    spawned gloo ranks; returns ``out[job][rank]``, a dict of numpy arrays."""
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    init = os.path.join(tmp, f"rendezvous_{world}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, jobs, tmp), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    t_end = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            if any(c not in (None, 0) for c in codes) or time.monotonic() > t_end:
                errs = []
                for r in range(world):
                    path = os.path.join(tmp, f"rank{r}.err")
                    if os.path.exists(path):
                        with open(path) as f:
                            errs.append(f.read())
                raise RuntimeError(
                    f"ranks ended with exit codes {codes} "
                    f"({'deadline passed' if time.monotonic() > t_end else 'a rank failed'})\n"
                    + "\n".join(errs)
                )
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
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


def _t(tree):
    from niceslam_tpu_torch.convert import to_torch

    return to_torch(tree, "cpu")


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
    injected draws ``p["pixels"]``: losses, the assembled grids, the decoder
    leaves and the cameras."""
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam.mapper import init_opt_state, make_pass_params

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    grids, masks = _t(p["grids"]), _t(p["masks"])
    pp = make_pass_params(rt.split(grids), _t(p["decoders"]), _t(p["cams"]), p["pcfg"])
    opt = init_opt_state(pp)
    pixels = {it: tuple(torch.from_numpy(a).long() for a in d) for it, d in p["pixels"].items()}
    losses = rt.run_schedule(
        pp, opt, p["sched"], rt.split(masks), _t(p["bounds"]), _t(p["scene_bound"]),
        p["intr"], _t(p["colors"]), _t(p["depths"]), p["valid"], p["fixed"],
        p["pcfg"], p["rcfg"], pixels=pixels,
    )
    out = {"loss": losses, "cams": pp.params["cams"]}
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


def _eager_runtime(mesh):
    """A runtime whose passes run eagerly whatever its mesh, as every
    runtime's did before the kf-sharded program: the reference of
    :func:`slam_job`."""
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime

    class EagerRuntime(MapKfRuntime):
        eager_passes = True

    return EagerRuntime(mesh, "cpu", "gloo")


def _eager_runtime_slam():
    """``NiceSLAM`` as it ran under a runtime before its programs: the pose
    solve by ``track_frame`` on the published map, the passes by
    ``rt.run_schedule`` per chunk."""
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from niceslam_tpu_torch.slam.tracker import track_frame

    class EagerRuntimeSLAM(NiceSLAM):
        def _solve(self, frame, init, td=None):
            st = self.state
            return track_frame(st.decoders, st.grids, self.bounds, self.scene_bound,
                               self.intr, frame.color, frame.depth, init, self.tcfg,
                               self.rcfg, gen=self.gen)

    return EagerRuntimeSLAM


def slam_job(n_map, n_kf, p):
    """A runtime-attached ``NiceSLAM`` on the CPU (capture off) over
    ``p["frames"]`` frames of the synthetic scene, for each sync method of
    ``p["syncs"]``: through its programs (``programs/<sync>/...``), as the
    eager runtime path (``eager/<sync>/...``) and, for the first sync
    method, through its programs after ``precompile()`` (``precompiled/...``,
    with whether ``precompile`` moved the generator and the programs it
    made)."""
    import dataclasses

    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam.system import NiceSLAM

    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cpu", "gloo")
    out = {}
    for k, sync in enumerate(p["syncs"]):
        cfg = dataclasses.replace(p["cfg"], sync_method=sync)
        runs = [("programs", NiceSLAM, rt), ("eager", _eager_runtime_slam(),
                                             _eager_runtime(rt.mesh))]
        if k == 0:
            runs.append(("precompiled", NiceSLAM, rt))
        for kind, cls, runtime in runs:
            slam = cls(cfg, reader=SyntheticBoxReader(cfg, n_frames=p["frames"]), seed=p["seed"],
                       device="cpu")
            runtime.attach(slam)
            if kind == "precompiled":
                state = slam.gen.get_state()
                slam.precompile()
                progs = slam._programs
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
        "slam": slam_job}
