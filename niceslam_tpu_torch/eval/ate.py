"""Absolute trajectory error: Umeyama alignment + RMSE (host-side numpy)."""
from __future__ import annotations

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning ``src`` to ``dst`` [N, 3].

    Returns ``(s, R, t)`` with ``dst ~ s * R @ src + t``.
    """
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
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_c2w, gt_c2w, with_scale: bool = False) -> float:
    """ATE RMSE in the same units as the poses (meters), Umeyama-aligned."""
    est_t = np.asarray([np.asarray(p)[:3, 3] for p in est_c2w])
    gt_t = np.asarray([np.asarray(p)[:3, 3] for p in gt_c2w])
    s, R, t = umeyama_align(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = np.linalg.norm(aligned - gt_t, axis=1)
    return float(np.sqrt((err**2).mean()))
