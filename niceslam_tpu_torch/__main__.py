"""Command line: run the port's SLAM loop on a YAML-configured stream.

    python -m niceslam_tpu_torch configs/cofusion.yaml --set dataset=synthetic \\
        --frames 12 --ckpt-dir out/ckpts --trajectory out/traj.npy \\
        --mesh out/mesh.ply --mesh-resolution 64 [--cpu]
    python -m niceslam_tpu_torch configs/cofusion.yaml \
        --set data.input_folder=data/cofusion/room4 --vis-dir out/vis \
        --profile-dir out/prof

It runs on the CUDA card unless ``--cpu`` is given. ``--set K=V`` overrides
a dotted config key (the value is read as JSON where it parses, else as a
string): ``--set sync_method=async --set tracking.method=adam``. Frames come
through the prefetcher; with ``--ckpt-dir`` a checkpoint is written every
``mapping.ckpt_freq`` frames (after the pending async guard is settled, so
no unverified map is saved), and ``--resume CKPT`` continues from one; with
``--mesh`` a mesh is written every ``mapping.mesh_freq`` frames and at the
end; with ``--vis-dir`` a render panel every ``mapping.vis_freq`` frames
(``utils/visualizer.py``); with ``--profile-dir`` a ``torch.profiler``
trace of the frame loop, ``trace.json``, holding the ``track`` and ``map``
ranges. The dataset is ``cfg.dataset`` read from ``data.input_folder``
(``io/datasets``; the config's ``data:`` block overrides a top-level
``data_input_folder``). The last line of standard output is
``{"frames": .., "fps_avg": .., "ate_rmse_cm": ..}``.

On the card the pose solves and mapping iterations run as CUDA graphs
(``slam/programs.py``), and ``NiceSLAM.precompile`` captures every
signature before the first frame; ``--no-precompile`` skips that, and each
graph is then captured when first met. With ``--cpu`` they run eagerly.

On N ranks (``parallel.n_processes: N``, ``parallel.map`` x ``parallel.kf``
= N, ``parallel/runtime.py``) every rank runs this command with its own
``--process-id`` (or ``NICESLAM_PROCESS_ID``), the same config and the same
``parallel.coordinator``:

    for r in 0 1; do python -m niceslam_tpu_torch configs/cofusion.yaml \
        --set dataset=synthetic --set parallel.n_processes=2 \
        --set parallel.map=2 --process-id $r & done; wait

On the card the ranks' solves and mapping passes replay graphs too, with
a pass's collectives run eagerly between two replays: with one map block
(``parallel.map: 1``) each iteration is two graphs around the all_reduce of
its gradients, with ``map > 1`` the segments of
``parallel/sharded_mapper.MapSegments`` around 3 all_reduces (4 with
``kf > 1``).

Only rank 0 prints, writes the trajectory, meshes, panels, checkpoints and
the profile, and logs to ``--log``; rank ``r > 0`` logs to
``<log stem>.rank<r>.jsonl``. At the end every rank's trajectory must equal
rank 0's bit for bit, else the command fails. The last event of every
rank's log, ``{"event": "programs"}``, says whether its programs ran as
graphs, how many graphs of each kind it captured, and the segments of its
mapping graphs (``grads``/``step`` on kf, ``halo``, ``sample``, ``grads``,
``gather``, ``step`` with ``map > 1``; none on one rank).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from collections import Counter

import numpy as np
import torch

from .config.schema import load_config
from .eval.mesher import extract_mesh, postprocess_mesh, write_ply
from .io.prefetch import Prefetcher
from .parallel.runtime import setup_runtime
from .slam.system import NiceSLAM
from .utils.checkpoint import save_checkpoint
from .utils.profiling import trace


def parse_overrides(items):
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def dump_mesh(slam: NiceSLAM, path: str, resolution: int):
    """Extract the map's mesh, clean it as ``meshing.*`` says against the
    estimated trajectory, and write it as ASCII PLY; returns its vertex and
    face counts."""
    mcfg = slam.cfg.meshing
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    st = slam.state
    verts, faces, colors = extract_mesh(
        st.decoders, st.grids, slam.bounds, slam.scene_bound,
        resolution=resolution, level=mcfg.level_set,
    )
    poses = np.stack([torch.as_tensor(p, dtype=torch.float32).cpu().numpy()
                      for p in slam.est_c2w])
    verts, faces, colors = postprocess_mesh(
        verts, faces, colors, mcfg, poses_c2w=poses, intr=slam.intr,
    )
    write_ply(path, verts, faces, colors)
    return len(verts), len(faces)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="dataset config yaml (configs/*.yaml)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="K=V")
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--mesh", default=None, help="write the final mesh here (.ply)")
    ap.add_argument("--mesh-resolution", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trajectory", default=None, help="save the poses (.npy)")
    ap.add_argument("--vis-dir", default=None, help="write render panels here")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the frame loop here")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="continue from a checkpoint file")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--no-precompile", action="store_true",
                    help="skip capturing every graph before the first frame (each is "
                         "then captured when first met, mid-run)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this rank's id when parallel.n_processes > 1 "
                         "(else NICESLAM_PROCESS_ID)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, overrides=parse_overrides(args.overrides))
    # The process group and the mesh come before any other use of the device.
    rt = setup_runtime(cfg, process_id=args.process_id, cpu=args.cpu)
    try:
        return _run(args, cfg, rt)
    finally:
        if rt.world > 1:
            torch.distributed.destroy_process_group()


def _run(args, cfg, rt) -> int:
    lead = rt.rank == 0
    log_path = args.log or os.path.join(cfg.output or "output", "metrics.jsonl")
    if not lead:
        log_path = f"{os.path.splitext(log_path)[0]}.rank{rt.rank}.jsonl"
        cfg = dataclasses.replace(cfg, verbose=False)
    slam = NiceSLAM(cfg, device=rt.device, log_path=log_path)
    rt.attach(slam)
    slam.vis_dir = args.vis_dir if lead else None
    n = args.frames if args.frames is not None else len(slam.reader)
    slam.n_imgs = n
    start = slam.restore(args.resume) if args.resume else 0
    if not args.no_precompile:
        slam.precompile()
    mesh_every, ckpt_every = cfg.mapping.mesh_freq, cfg.mapping.ckpt_freq
    mesh_stem = os.path.splitext(args.mesh)[0] if args.mesh and lead else None
    profile_dir = args.profile_dir if lead else None

    pf = Prefetcher(slam.reader, device=slam.device, start=start, end=n)
    with trace(profile_dir) if profile_dir else contextlib.nullcontext(), \
            contextlib.closing(pf):
        for i, frame in enumerate(pf, start=start):
            slam.step(frame)
            if mesh_stem and mesh_every > 0 and i > 0 and i % mesh_every == 0:
                dump_mesh(slam, f"{mesh_stem}_frame{i:06d}.ply", args.mesh_resolution)
            if args.ckpt_dir and i > 0 and i % ckpt_every == 0:
                # Never persist an unverified map. Every rank settles its
                # guard here, so that all of them roll back at one frame.
                slam.flush()
                if lead:
                    save_checkpoint(
                        os.path.join(args.ckpt_dir, f"frame_{i:06d}"),
                        slam.state, slam.est_c2w, slam.gt_c2w, i,
                        bounds=slam.bounds, scene_bound=slam.scene_bound,
                    )
        res = slam.result()
    progs = slam._programs
    slam.log.log({
        "event": "programs", "graphed": progs.capture,
        "graphs": dict(Counter(cp.signature.split()[0] for cp in progs.captures)),
        "map_segments": sorted({
            seg for cp in progs.captures if cp.signature.startswith("map ")
            for seg in cp.signature.split(" route=")[0].split()[-1].split("+")
            if not seg.startswith("stage=")}),
    })
    if not rt.ranks_agree(torch.as_tensor(np.asarray(res["est_c2w"], np.float32))):
        raise RuntimeError(f"rank {rt.rank}: the ranks' trajectories differ")
    slam.log.close()
    if not lead:
        return 0
    if cfg.verbose:
        print(f"[niceslam] timer: {json.dumps(slam.timer.summary())}")
    if args.trajectory:
        os.makedirs(os.path.dirname(args.trajectory) or ".", exist_ok=True)
        np.save(args.trajectory, np.asarray(res["est_c2w"]))
    if args.mesh:
        nv, nf = dump_mesh(slam, args.mesh, args.mesh_resolution)
        print(f"mesh: {nv} verts, {nf} faces -> {args.mesh}")
    ate = res.get("ate_rmse")
    print(json.dumps({
        "frames": n,
        "fps_avg": round(slam.log.fps, 3),
        "ate_rmse_cm": None if ate is None else round(ate * 100, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
