"""Both packages on a prefix of the reference envelope, from one initial state.

The reference envelope's command (``configs/cofusion_synth849.yaml`` with
the ``--set``s of ``LONGRUN_r05.json``, as ``chip_smoke.LONGRUN_SETS``
holds them) runs random decoders, and each package draws its own from its
own generator, so two runs of it cannot be compared as they are. This
script writes the first ``frames`` frames of the 849-frame fixture
(``niceslam_tpu_torch.make_fixture_dataset``, the same poses as the full
fixture's), builds the JAX system on them with the command's configuration
and seed 0 (``run_slam.py``'s), and gives the port the JAX system's initial
grids and decoders; each package draws its own pixels. Each run prints its
ATE, its raw position error
every 5 frames and the first frame whose raw error reaches the smoke's
lost-track bound (45 cm; ``chip_smoke.RAW_LOST_CM``).

    JAX_PLATFORMS=cpu python tests/reference_witness.py [frames]
        [--only jax|torch] [--log-dir DIR]

``--log-dir`` keeps each run's metrics JSONL (``jax.jsonl``,
``torch.jsonl``), one line a frame and a mapping pass as it runs.

About 40 CPU-minutes a package at 60 frames (640x480, the command's full
budgets), so the two are best run side by side with ``--only``; not part of
the test suite.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

CONFIG = os.path.join(_ROOT, "configs", "cofusion_synth849.yaml")
RAW_LOST_CM = 45.0


def _overrides(data: str):
    from chip_smoke import LONGRUN_SETS
    from run_slam import parse_overrides

    return parse_overrides([f"data.input_folder={data}", *LONGRUN_SETS])


def _report(name, res, t0):
    est = np.stack([np.asarray(p) for p in res["est_c2w"]])[:, :3, 3]
    gt = np.stack([np.asarray(p) for p in res["gt_c2w"]])[:, :3, 3]
    raw = 100 * np.linalg.norm(est - gt, axis=1)
    first = next((k for k, e in enumerate(raw) if e >= RAW_LOST_CM), None)
    print(f"{name}: ATE {100 * res['ate_rmse']:.3f} cm over {len(raw)} frames, raw position "
          f"error (cm) every 5 frames {[round(float(e), 2) for e in raw[::5]]}, last "
          f"{raw[-1]:.2f}; raw error first >= {RAW_LOST_CM} cm at frame {first}; "
          f"{time.time() - t0:.0f} s", flush=True)
    return raw


def main(frames=60, only=None, log_dir=None):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    from niceslam_tpu.config.schema import load_config as jax_load
    from niceslam_tpu.slam.system import NiceSLAM as JaxSLAM
    from niceslam_tpu_torch import convert
    from niceslam_tpu_torch import make_fixture_dataset as fixture
    from niceslam_tpu_torch.config.schema import load_config
    from niceslam_tpu_torch.slam.system import NiceSLAM

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cofusion_synth849")
        fixture.write_layout("cofusion", data, frames, arc=2.0 * frames / 849, workers=2)
        over = _overrides(data)
        logs = {k: os.path.join(log_dir or tmp, f"{k}.jsonl") for k in ("jax", "torch")}
        jslam = JaxSLAM(jax_load(CONFIG, overrides=over), seed=0, log_path=logs["jax"])
        grids0 = jax.tree_util.tree_map(np.asarray, jslam.state.grids)
        decoders0 = jax.tree_util.tree_map(np.asarray, jslam.state.decoders)
        if only != "torch":
            t0 = time.time()
            _report("jax", jslam.run(frames), t0)
        if only == "jax":
            return
        slam = NiceSLAM(load_config(CONFIG, overrides=over), seed=0, device="cpu",
                        log_path=logs["torch"])
        slam.state.grids = convert.grids_from_jax(grids0, "cpu")
        slam.state.decoders = convert.decoders_from_jax(decoders0, "cpu")
        t0 = time.time()
        _report("torch", slam.run(frames), t0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", type=int, nargs="?", default=60)
    ap.add_argument("--only", choices=("torch", "jax"), default=None)
    ap.add_argument("--log-dir", default=None)
    a = ap.parse_args()
    if a.frames < 2:
        ap.error("frames: at least 2 (the ATE aligns two or more poses)")
    main(a.frames, a.only, a.log_dir)
