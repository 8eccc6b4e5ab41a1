"""End-to-end accuracy of the port against the JAX package on the tiny CPU
world: the accuracy tripwire's configuration and 12-frame trajectory, run by
both packages for the same seeds, printing each run's ATE and raw per-frame
position error. The packages draw different pixels, so the comparison is of
distributions, not of trajectories. ``--method`` picks the tracker (``gn``,
the default, or ``adam``) and ``--sync`` the sync method (``strict`` or
``async``), for both packages alike.

    JAX_PLATFORMS=cpu python tests/torch_vs_jax_accuracy.py [frames] [seeds] \
        [--first-seed S] [--method gn|adam] [--sync strict|async] \
        [--importance N] [--replay | --only torch|jax] [--draw-offset K]

- ``--replay`` runs the port on the JAX run's random draws (every tracking,
  mapping and overlap pixel batch, recomputed from the keys the JAX run
  used) from the JAX run's initial grids, so that the two runs differ only
  by arithmetic; it prints the paired difference of the ATEs. It patches
  the draw sites where the port's system calls them
  (``slam.system.draw_track_pixels``, ``draw_pixels`` and
  ``draw_mapping_pixels``, the last once per row of a pass); a pass's rows
  take the JAX run's schedule chunks' active iterations in order, and any
  draw of one package that the other does not make raises.
- ``--importance N`` sets ``rendering.N_importance`` in both packages. Both
  place the importance samples without drawing (the renderer gets no key
  or generator on the system's path), so the replay needs nothing more.
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
from functools import partial

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

NPZ = os.path.join(_ROOT, "models", "pretrained_decoders.npz")


def _tripwire(cfg, method: str, sync: str, importance: int = 0):
    return dataclasses.replace(
        cfg,
        sync_method=sync,
        pretrained_middle_fine=NPZ,
        tracking=dataclasses.replace(cfg.tracking, method=method),
        mapping=dataclasses.replace(cfg.mapping, bootstrap_frames=4, fs_weight=1.0),
        rendering=dataclasses.replace(cfg.rendering, N_importance=importance),
    )


def _report(name, seed, res, t0):
    raw = raw_errors_cm(res)
    print(f"{name} seed {seed}: ATE {100 * res['ate_rmse']:.3f} cm, raw position "
          f"error per frame (cm) {[round(float(e), 2) for e in raw]}, "
          f"{time.time() - t0:.0f} s", flush=True)


class DrawRecorder:
    """Records the keys of a JAX ``NiceSLAM`` run's random draws, in order,
    and hands the port the same pixels recomputed from them. ``precompile``
    draws from fixed dummy keys, not the run's: what it calls while it runs
    is not recorded (``run`` does not call it)."""

    def __init__(self, jax_slam):
        import jax
        import niceslam_tpu.slam.keyframes as jkf
        import niceslam_tpu.slam.system as jsys

        self.jax, self.queue, self._undo, self._paused = jax, [], [], 0
        jr = jax.random

        # The draws as the JAX run makes them, compiled once per shape.
        @partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
        def sample(key, n, H, W, eh, ew):
            if key.ndim > 1:
                return jax.vmap(lambda k: sample(k, n, H, W, eh, ew))(key)
            kj, ki = jr.split(key)
            return jr.randint(kj, (n,), eh, H - eh), jr.randint(ki, (n,), ew, W - ew)

        @partial(jax.jit, static_argnums=(3, 4, 5))
        def mapping(key, iters, logits, n, H, W):
            def one(it):
                kf, kj, ki = jr.split(jr.fold_in(key, it), 3)
                return (jr.categorical(kf, logits, shape=(n,)), jr.randint(ki, (n,), 0, W),
                        jr.randint(kj, (n,), 0, H))
            return jax.vmap(one)(iters)

        @jax.jit
        def folds(key, iters):
            return jax.vmap(lambda it: jr.fold_in(key, it))(iters)

        self._sample, self._mapping, self._folds = sample, mapping, folds

        def wrap(owner, name, record):
            orig = getattr(owner, name)

            def fn(*a, **k):
                if not self._paused:
                    self.queue.append(record(*a))
                return orig(*a, **k)

            self._undo.append((owner, name, orig))
            setattr(owner, name, fn)

        np_ = np.asarray
        wrap(jsys, "track_frame", lambda *a: ("track", np_(a[8])))
        wrap(jkf, "keyframe_overlap_percentages", lambda *a: ("overlap", np_(a[0])))
        wrap(jax_slam, "run_schedule_fn", lambda *a: (
            "map", np_(a[11]), np_(a[12].iter_idx), np_(a[12].active), np_(a[9])))
        precompile = jax_slam.precompile

        def unrecorded(*a, **k):
            self._paused += 1
            try:
                return precompile(*a, **k)
            finally:
                self._paused -= 1

        self._undo.append((jax_slam, "precompile", precompile))
        jax_slam.precompile = unrecorded

    def close(self):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)

    def _pop(self, kind):
        if not self.queue:
            raise AssertionError(f"the port draws for {kind} where the JAX run drew no more")
        rec = self.queue.pop(0)
        if rec[0] != kind:
            raise AssertionError(f"the port draws for {kind} where JAX drew for {rec[0]}")
        return rec[1:]

    def _pixels(self, key, n, H, W, eh=0, ew=0):
        """``core/rays.sample_rays``' draws from ``key`` (or from each of a
        stack of keys): ``(i, j)``."""
        import torch

        j, i = (np.asarray(t, np.int64) for t in self._sample(
            self.jax.numpy.asarray(key), n, H, W, eh, ew))
        return torch.from_numpy(i), torch.from_numpy(j)

    def track_pixels(self, gen, intr, cfg, device):
        """One solve's draws, as ``slam/tracker.draw_track_pixels`` gives them."""
        (key,) = self._pop("track")
        keys = self._folds(self.jax.numpy.asarray(key), self.jax.numpy.arange(cfg.iters))
        i, j = self._pixels(keys, cfg.pixels, intr.H, intr.W, cfg.ignore_edge_H,
                            cfg.ignore_edge_W)
        return list(zip(i, j))

    def overlap_pixels(self, gen, intr, n, *a, **k):
        """The overlap batch, as ``core/rays.draw_pixels`` gives it."""
        (key,) = self._pop("overlap")
        return self._pixels(key, n, intr.H, intr.W)

    def mapping_rows(self, valid_idx, n, intr, first: bool):
        """The next JAX ``run_schedule`` chunk's draws, ``(fidx, i, j)`` of
        each active iteration in order, as ``slam/mapper.mapping_loss``
        draws them. ``first`` says whether the port starts a pass here: the
        chunk must then be its pass's first (iteration 0), and otherwise
        not. ``valid_idx`` are the port's valid window slots, which must be
        the chunk's."""
        import torch

        jnp = self.jax.numpy
        key, iters, active, valid = self._pop("map")
        if (int(iters[0]) == 0) != first:
            raise AssertionError("the port's mapping passes part from the JAX run's: "
                                 f"a port {'pass starts' if first else 'row continues'} at "
                                 f"JAX iteration {int(iters[0])}")
        if not np.array_equal(np.flatnonzero(valid), np.asarray(valid_idx)):
            raise AssertionError("the port's mapping window differs from the JAX run's")
        logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
        draws = self._mapping(jnp.asarray(key), jnp.asarray(iters[active.astype(bool)]),
                              logits, n, intr.H, intr.W)
        fidx, i, j = (torch.from_numpy(np.asarray(d, np.int64)) for d in draws)
        return list(zip(fidx, i, j))


def _replaying(rec, slam):
    """Patch the port's draw sites, where ``slam`` calls them, to take
    ``rec``'s pixels: ``slam.system``'s ``draw_track_pixels`` (a solve),
    ``draw_pixels`` (the overlap batch) and ``draw_mapping_pixels`` (one call
    per row, a whole pass up front in ``NiceSLAM._map_pass``). A pass's rows
    take the JAX chunks' active iterations in order; a pass that ends
    inside a chunk, or a chunk that parts from a pass, raises. Returns an
    undo."""
    import niceslam_tpu_torch.slam.system as tsys

    rows, at = [], {"pass_start": False}

    def mapping_row(gen, valid_idx, n, intr, device):
        if not rows:
            rows.extend(rec.mapping_rows(valid_idx.cpu().numpy(), n, intr, at["pass_start"]))
        at["pass_start"] = False
        return tuple(t.to(device) for t in rows.pop(0))

    map_pass = slam._map_pass

    def replayed_pass(*a, **k):
        at["pass_start"] = True
        out = map_pass(*a, **k)
        if rows:
            raise AssertionError(f"the port's pass ended with {len(rows)} rows of the JAX "
                                 "chunk left: the two passes' row counts differ")
        return out

    saved = [(tsys, "draw_track_pixels"), (tsys, "draw_pixels"), (tsys, "draw_mapping_pixels")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    tsys.draw_track_pixels = rec.track_pixels
    tsys.draw_pixels = rec.overlap_pixels
    tsys.draw_mapping_pixels = mapping_row
    slam._map_pass = replayed_pass
    return lambda: [setattr(m, n, f) for m, n, f in saved]


def raw_errors_cm(res) -> np.ndarray:
    """Each frame's position error (cm, unaligned) of a run's result."""
    est = np.stack([np.asarray(p) for p in res["est_c2w"]])[:, :3, 3]
    gt = np.stack([np.asarray(p) for p in res["gt_c2w"]])[:, :3, 3]
    return 100 * np.linalg.norm(est - gt, axis=1)


def run_seed(seed, frames=12, method="gn", sync="strict", importance=0, replay=False,
             only=None, draw_offset=0, log=True):
    """One seed of both packages (or ``only`` one) on the tripwire world:
    ``{package: (result, system)}``. With ``replay`` the port runs on the
    JAX run's draws from its initial grids, and every JAX draw must be
    used."""
    import jax

    from integration.conftest import tiny_config as jax_tiny
    from niceslam_tpu.io.datasets.synthetic import SyntheticBoxReader as JaxReader
    from niceslam_tpu.slam.system import NiceSLAM as JaxSLAM
    from niceslam_tpu_torch import convert
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from test_torch_slam import tiny_config

    tname = torch_name(replay, draw_offset)
    out, rec, grids0 = {}, None, None
    if only != "torch":
        t0 = time.time()
        cfg = _tripwire(jax_tiny(), method, sync, importance)
        reader = JaxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
        slam = JaxSLAM(cfg, reader=reader, seed=seed)
        if replay:
            rec = DrawRecorder(slam)
            grids0 = jax.tree_util.tree_map(np.asarray, slam.state.grids)
        try:
            out["jax"] = (slam.run(frames), slam)
        finally:
            if rec is not None:
                rec.close()
        if log:
            _report("jax", seed, out["jax"][0], t0)
    if only == "jax":
        return out
    t0 = time.time()
    cfg = _tripwire(tiny_config(), method, sync, importance)
    reader = SyntheticBoxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
    slam = NiceSLAM(cfg, reader=reader, seed=seed, device="cpu")
    if draw_offset:
        slam.gen.manual_seed(seed + draw_offset)
    undo = lambda: None  # noqa: E731
    if replay:
        slam.state.grids = convert.grids_from_jax(grids0, "cpu")
        undo = _replaying(rec, slam)
    try:
        out[tname] = (slam.run(frames), slam)
    finally:
        undo()
    if replay and rec.queue:
        raise AssertionError(f"{len(rec.queue)} JAX draws left unused")
    if log:
        _report(tname, seed, out[tname][0], t0)
    return out


def torch_name(replay=False, draw_offset=0) -> str:
    return "torch (JAX draws)" if replay else (
        f"torch (draws seed + {draw_offset})" if draw_offset else "torch")


def main(frames=12, seeds=4, method="gn", sync="strict", first_seed=0, replay=False,
         only=None, draw_offset=0, importance=0):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    tname = torch_name(replay, draw_offset)
    ates = {"jax": [], tname: []}
    for seed in range(first_seed, first_seed + seeds):
        for name, (res, _) in run_seed(seed, frames, method, sync, importance, replay, only,
                                       draw_offset).items():
            ates[name].append(100 * res["ate_rmse"])
    setting = f"{method}, {sync}, N_importance {importance}"
    for name, a in ates.items():
        if a:
            print(f"{name} ({setting}): ATE per seed {[round(x, 3) for x in a]}, "
                  f"mean {np.mean(a):.3f} cm, standard error "
                  f"{np.std(a, ddof=1) / np.sqrt(len(a)) if len(a) > 1 else float('nan'):.3f}")
    if replay and len(ates[tname]) > 1:
        d = np.asarray(ates[tname]) - np.asarray(ates["jax"])
        print(f"paired difference torch - jax on the same draws ({setting}): mean "
              f"{d.mean():.3f} cm, standard error {d.std(ddof=1) / np.sqrt(len(d)):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", type=int, nargs="?", default=12)
    ap.add_argument("seeds", type=int, nargs="?", default=4)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--method", choices=("gn", "adam"), default="gn")
    ap.add_argument("--sync", choices=("strict", "async"), default="strict")
    ap.add_argument("--importance", type=int, default=0)
    ap.add_argument("--replay", action="store_true")
    ap.add_argument("--only", choices=("torch", "jax"), default=None)
    ap.add_argument("--draw-offset", type=int, default=0)
    a = ap.parse_args()
    if a.replay and a.only:
        ap.error("--replay runs both packages")
    main(a.frames, a.seeds, a.method, a.sync, a.first_seed, a.replay, a.only, a.draw_offset,
         a.importance)
