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


JOBS = {"halo": halo_job, "mapping": mapping_job}
