"""End-to-end accuracy of the port against the JAX package on the tiny CPU
world: the accuracy tripwire's configuration and 12-frame trajectory, run by
both packages for the same seeds, printing each run's ATE and raw per-frame
position error. The packages draw different pixels, so the comparison is of
distributions, not of trajectories. ``--method`` picks the tracker (``gn``,
the default, or ``adam``) and ``--sync`` the sync method (``strict`` or
``async``), for both packages alike.

    JAX_PLATFORMS=cpu python tests/torch_vs_jax_accuracy.py [frames] [seeds] \
        [--first-seed S] [--method gn|adam] [--sync strict|async] \
        [--replay | --only torch|jax] [--draw-offset K]

- ``--replay`` runs the port on the JAX run's random draws (every tracking,
  mapping and overlap pixel batch, recomputed from the keys the JAX run
  used) from the JAX run's initial grids, so that the two runs differ only
  by arithmetic; it prints the paired difference of the ATEs.
- ``--draw-offset K`` seeds the port's pixel-draw generator with
  ``seed + K`` instead of ``seed``.
- ``--only`` runs one package.

Each summary line gives the mean ATE over the seeds and its standard error.
Several CPU-minutes (about 35 s per seed and package); not part of the test
suite.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

NPZ = os.path.join(_ROOT, "models", "pretrained_decoders.npz")


def _tripwire(cfg, method: str, sync: str):
    return dataclasses.replace(
        cfg,
        sync_method=sync,
        pretrained_middle_fine=NPZ,
        tracking=dataclasses.replace(cfg.tracking, method=method),
        mapping=dataclasses.replace(cfg.mapping, bootstrap_frames=4, fs_weight=1.0),
    )


def _report(name, seed, res, t0):
    est = np.stack([np.asarray(p) for p in res["est_c2w"]])[:, :3, 3]
    gt = np.stack([np.asarray(p) for p in res["gt_c2w"]])[:, :3, 3]
    raw = 100 * np.linalg.norm(est - gt, axis=1)
    print(f"{name} seed {seed}: ATE {100 * res['ate_rmse']:.3f} cm, raw position "
          f"error per frame (cm) {[round(float(e), 2) for e in raw]}, "
          f"{time.time() - t0:.0f} s", flush=True)
    return 100 * res["ate_rmse"]


class DrawRecorder:
    """Records the keys of a JAX ``NiceSLAM`` run's random draws, in order,
    and hands the port the same pixels recomputed from them."""

    def __init__(self, jax_slam):
        import jax
        import niceslam_tpu.slam.keyframes as jkf
        import niceslam_tpu.slam.system as jsys

        self.jax, self.queue, self._undo = jax, [], []

        def wrap(owner, name, record):
            orig = getattr(owner, name)

            def fn(*a, **k):
                self.queue.append(record(*a))
                return orig(*a, **k)

            self._undo.append((owner, name, orig))
            setattr(owner, name, fn)

        np_ = np.asarray
        wrap(jsys, "track_frame", lambda *a: ("track", np_(a[8])))
        wrap(jkf, "keyframe_overlap_percentages", lambda *a: ("overlap", np_(a[0])))
        wrap(jax_slam, "run_schedule_fn", lambda *a: (
            "map", np_(a[11]), np_(a[12].iter_idx), np_(a[12].active), np_(a[9])))

    def close(self):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)

    def _pop(self, kind):
        rec = self.queue.pop(0)
        if rec[0] != kind:
            raise AssertionError(f"the port draws for {kind} where JAX drew for {rec[0]}")
        return rec[1:]

    def _pixels(self, key, n, H, W, eh=0, ew=0):
        """``core/rays.sample_rays``' draws from ``key``: ``(i, j)``."""
        import torch

        jr = self.jax.random
        kj, ki = jr.split(self.jax.numpy.asarray(key))
        j = np.asarray(jr.randint(kj, (n,), eh, H - eh), np.int64)
        i = np.asarray(jr.randint(ki, (n,), ew, W - ew), np.int64)
        return torch.from_numpy(i), torch.from_numpy(j)

    def track_pixels(self, gen, intr, cfg, device):
        (key,) = self._pop("track")
        fold = self.jax.random.fold_in
        return [self._pixels(fold(key, it), cfg.pixels, intr.H, intr.W,
                             cfg.ignore_edge_H, cfg.ignore_edge_W)
                for it in range(cfg.iters)]

    def overlap_pixels(self, gen, intr, n, *a, **k):
        (key,) = self._pop("overlap")
        return self._pixels(key, n, intr.H, intr.W)

    def mapping_pixels(self, chunk, frame_valid, n, intr):
        """``{iter_idx: (fidx, i, j)}`` of ``slam/mapper.mapping_loss``'s draws."""
        import torch

        jr, jnp = self.jax.random, self.jax.numpy
        key, iters, active, valid = self._pop("map")
        if not (np.array_equal(iters, np.asarray(chunk.iter_idx))
                and np.array_equal(valid, frame_valid)):
            raise AssertionError("the port's mapping chunk differs from the JAX run's")
        logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
        out = {}
        for it in iters[active.astype(bool)]:
            kf, kj, ki = jr.split(jr.fold_in(jnp.asarray(key), int(it)), 3)
            draws = (jr.categorical(kf, logits, shape=(n,)), jr.randint(ki, (n,), 0, intr.W),
                     jr.randint(kj, (n,), 0, intr.H))
            out[int(it)] = tuple(torch.from_numpy(np.asarray(d, np.int64)) for d in draws)
        return out


def _replaying(rec):
    """Patch the port's draw sites to take ``rec``'s pixels; returns an undo."""
    import niceslam_tpu_torch.slam.system as tsys
    import niceslam_tpu_torch.slam.tracker as ttr

    run_schedule = tsys.run_schedule

    def replayed(pp, opt_state, chunk, masks, bounds, sb, intr, colors, depths, valid,
                 fixed, pcfg, rcfg, gen=None, pixels=None):
        px = rec.mapping_pixels(chunk, valid, pcfg.n_pixels, intr)
        return run_schedule(pp, opt_state, chunk, masks, bounds, sb, intr, colors, depths,
                            valid, fixed, pcfg, rcfg, gen=gen, pixels=px)

    saved = [(ttr, "draw_track_pixels"), (tsys, "draw_pixels"), (tsys, "run_schedule")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    ttr.draw_track_pixels = rec.track_pixels
    tsys.draw_pixels = rec.overlap_pixels
    tsys.run_schedule = replayed
    return lambda: [setattr(m, n, f) for m, n, f in saved]


def main(frames=12, seeds=4, method="gn", sync="strict", first_seed=0, replay=False,
         only=None, draw_offset=0):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    from integration.conftest import tiny_config as jax_tiny
    from niceslam_tpu.io.datasets.synthetic import SyntheticBoxReader as JaxReader
    from niceslam_tpu.slam.system import NiceSLAM as JaxSLAM
    from niceslam_tpu_torch import convert
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from test_torch_slam import tiny_config

    tname = "torch (JAX draws)" if replay else (
        f"torch (draws seed + {draw_offset})" if draw_offset else "torch")
    ates = {"jax": [], tname: []}
    for seed in range(first_seed, first_seed + seeds):
        rec = grids0 = None
        if only != "torch":
            t0 = time.time()
            cfg = _tripwire(jax_tiny(), method, sync)
            reader = JaxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
            slam = JaxSLAM(cfg, reader=reader, seed=seed)
            if replay:
                rec = DrawRecorder(slam)
                grids0 = jax.tree_util.tree_map(np.asarray, slam.state.grids)
            try:
                ates["jax"].append(_report("jax", seed, slam.run(frames), t0))
            finally:
                if rec is not None:
                    rec.close()
        if only == "jax":
            continue
        t0 = time.time()
        cfg = _tripwire(tiny_config(), method, sync)
        reader = SyntheticBoxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
        slam = NiceSLAM(cfg, reader=reader, seed=seed, device="cpu")
        if draw_offset:
            slam.gen.manual_seed(seed + draw_offset)
        undo = lambda: None  # noqa: E731
        if replay:
            slam.state.grids = convert.grids_from_jax(grids0, "cpu")
            undo = _replaying(rec)
        try:
            ates[tname].append(_report(tname, seed, slam.run(frames), t0))
        finally:
            undo()
        if replay and rec.queue:
            raise AssertionError(f"{len(rec.queue)} JAX draws left unused")
    for name, a in ates.items():
        if a:
            print(f"{name} ({method}, {sync}): ATE per seed {[round(x, 3) for x in a]}, "
                  f"mean {np.mean(a):.3f} cm, standard error "
                  f"{np.std(a, ddof=1) / np.sqrt(len(a)) if len(a) > 1 else float('nan'):.3f}")
    if replay and len(ates[tname]) > 1:
        d = np.asarray(ates[tname]) - np.asarray(ates["jax"])
        print(f"paired difference torch - jax on the same draws: mean {d.mean():.3f} cm, "
              f"standard error {d.std(ddof=1) / np.sqrt(len(d)):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", type=int, nargs="?", default=12)
    ap.add_argument("seeds", type=int, nargs="?", default=4)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--method", choices=("gn", "adam"), default="gn")
    ap.add_argument("--sync", choices=("strict", "async"), default="strict")
    ap.add_argument("--replay", action="store_true")
    ap.add_argument("--only", choices=("torch", "jax"), default=None)
    ap.add_argument("--draw-offset", type=int, default=0)
    a = ap.parse_args()
    if a.replay and a.only:
        ap.error("--replay runs both packages")
    main(a.frames, a.seeds, a.method, a.sync, a.first_seed, a.replay, a.only, a.draw_offset)
