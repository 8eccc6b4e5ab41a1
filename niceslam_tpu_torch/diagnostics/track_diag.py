"""The tracker on a fitted map: the counterpart of the JAX package's
``scripts/track_diag.py``, with its arguments, configuration and record.

Maps the first 11 frames of the bench world at their true poses, then looks
at tracking frame 11:

- at its true pose, on 1,000 interior pixels (``np.random.default_rng(0)``):
  the rendered depth variance's percentiles, the uncertainty amplitude at
  its median, and the depth error's mean and percentiles;
- ``base``: one pose solve (``slam/tracker.track_frame``, 200 pixels x 10
  iterations) from frame 10's true pose, its translation error before and
  after and its loss curve, and the Adam tracker's loss
  (``slam/tracker.tracking_loss``) at the initial, tracked and true poses,
  all three on ONE set of pixels drawn once.

The solve draws its pixels from a generator seeded 5, the loss's from one
seeded 123 (the JAX script's keys 5 and 123); both can be injected.

    python -m niceslam_tpu_torch.diagnostics.track_diag [DECODERS|none] \\
        [DECODER_TRAIN] [N_TOTAL] [--cpu]

Defaults: ``models/pretrained_decoders.npz``, ``never``, 12. One JSON
object on standard output. It runs on the card unless ``--cpu`` is given,
and fails where no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config.schema import SLAMConfig, TrackingConfig
from ..core import rays as rays_mod
from ..core.pose import tensor_from_camera
from ..io.datasets.synthetic import SyntheticBoxReader
from ..render.renderer import render_rays
from ..slam import tracker as trk
from ..slam.system import NiceSLAM
from .bias_probe import interior_pixels
from .world import DECODERS, as_tensor, card, world_config

N_MAP = 11
N_PIXELS = 1000
TCFG = trk.TrackConfig(pixels=200, iters=10, lr=1e-3)
TRACK_SEED, LOSS_SEED = 5, 123


def config(pretrained: str = DECODERS, decoder_train: str = "never") -> SLAMConfig:
    return world_config(TrackingConfig(pixels=200, iters=10, gt_camera=True),
                        pretrained=pretrained, decoder_train=decoder_train)


def run(cfg: SLAMConfig, n_total: int, device):
    """The first ``N_MAP`` frames mapped at their true poses: ``(slam,
    reader)``, the reader holding ``n_total`` frames."""
    reader = SyntheticBoxReader(cfg, n_frames=n_total)
    slam = NiceSLAM(cfg, reader=reader, seed=0, device=device)
    slam.run(N_MAP)
    slam.result()
    return slam, reader


def measure(slam: NiceSLAM, reader, track_pixels=None, loss_pixels=None) -> dict:
    """The record, unrounded. ``track_pixels`` (one ``(i, j)`` pair per
    iteration) and ``loss_pixels`` (one ``(i, j)``) replace the solve's and
    the losses' draws."""
    dev = slam.device
    f, prev = reader[N_MAP], reader[N_MAP - 1]
    gt_c2w = as_tensor(f.gt_c2w, dev)
    color, depth = as_tensor(f.color, dev), as_tensor(f.depth, dev)
    params = (slam.state.decoders, slam.state.grids, slam.bounds, slam.scene_bound)

    ro_all, rd_all = rays_mod.rays_for_image(slam.intr, gt_c2w)
    jj, ii = interior_pixels(slam.intr.H, slam.intr.W, N_PIXELS)
    jt, it = torch.as_tensor(jj).to(dev), torch.as_tensor(ii).to(dev)
    with torch.no_grad():
        out = render_rays(*params, ro_all[jt, it], rd_all[jt, it], depth[jt, it], "color",
                          slam.rcfg)
    var, dep = out.depth_var.cpu().numpy(), out.depth.cpu().numpy()
    gtd = f.depth[jj, ii]
    err = np.abs(dep - gtd)
    res = {
        "depth_var_m2": {p: float(np.percentile(var, q))
                         for p, q in (("p10", 10), ("p50", 50), ("p90", 90))},
        "unc_amp_p50": float(1.0 / np.sqrt(np.percentile(var, 50) + 1e-10)),
        "depth_err_cm_at_gt": float(100 * err.mean()),
        "depth_err_cm_pcts": {p: float(100 * np.percentile(err, p)) for p in (10, 50, 90, 99)},
        "signed_err_cm_p50": float(100 * np.percentile(dep - gtd, 50)),
    }

    init = as_tensor(prev.gt_c2w, dev)
    c2w, losses = trk.track_frame(*params, slam.intr, color, depth, init, TCFG, slam.rcfg,
                                  gen=torch.Generator(device=dev).manual_seed(TRACK_SEED),
                                  pixels=track_pixels)
    c2w_np = c2w.cpu().numpy()
    base = {
        "t_err_cm_init": 100 * float(np.linalg.norm(prev.gt_c2w[:3, 3] - f.gt_c2w[:3, 3])),
        "t_err_cm_tracked": 100 * float(np.linalg.norm(c2w_np[:3, 3] - f.gt_c2w[:3, 3])),
        "loss_curve": [float(x) for x in losses.cpu().numpy()],
    }
    if loss_pixels is None:
        loss_pixels = rays_mod.draw_pixels(
            torch.Generator(device=dev).manual_seed(LOSS_SEED), slam.intr, TCFG.pixels,
            TCFG.ignore_edge_H, TCFG.ignore_edge_W, dev)
    i, j = (t.to(dev) for t in loss_pixels)
    for tag, pose in (("init", init), ("tracked", c2w), ("gt", gt_c2w)):
        with torch.no_grad():
            lv = trk.tracking_loss(*params, slam.intr, tensor_from_camera(pose), color, depth,
                                   i, j, TCFG, slam.rcfg)
        base[f"loss_at_{tag}"] = float(lv)
    res["base"] = base
    return res


def rounded(res: dict) -> dict:
    """The script's rounding: the error percentiles, the signed median and
    everything in ``base``; the rest as computed."""
    out = dict(res)
    out["depth_err_cm_pcts"] = {p: round(v, 2) for p, v in res["depth_err_cm_pcts"].items()}
    out["signed_err_cm_p50"] = round(res["signed_err_cm_p50"], 2)
    b = res["base"]
    out["base"] = {k: ([round(x, 2) for x in v] if k == "loss_curve"
                       else round(v, 3) if k.startswith("t_err") else round(v, 2))
                   for k, v in b.items()}
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pretrained", nargs="?", default=DECODERS)
    ap.add_argument("decoder_train", nargs="?", default="never")
    ap.add_argument("n_total", nargs="?", type=int, default=12)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    slam, reader = run(config(args.pretrained, args.decoder_train), args.n_total,
                       card(args.cpu))
    print(json.dumps(rounded(measure(slam, reader)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
