"""Absolute trajectory error: Umeyama alignment (rotation and translation,
no scale) of the estimated camera centres onto the true ones, then the root
mean square of the remaining distances. A copy of the arithmetic of the
port's ``eval/ate.py``."""
from __future__ import annotations

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """``(s, R, t)`` with ``dst ~ s R src + t`` in the least-squares sense."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src))) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_c2w, gt_c2w, with_scale: bool = False) -> float:
    """ATE RMSE in the poses' units."""
    est = np.asarray([np.asarray(p)[:3, 3] for p in est_c2w])
    gt = np.asarray([np.asarray(p)[:3, 3] for p in gt_c2w])
    s, R, t = umeyama_align(est, gt, with_scale)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))
