"""ATE evaluation: Umeyama alignment + RMSE (numpy; same as the reference's
``utils/evaluation.py``)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale=False):
    """Least-squares transform y ≈ c R x + t for x, y [N, 3]; returns (R, t, c)."""
    mu_x, mu_y = x.mean(axis=0), y.mean(axis=0)
    xc, yc = x - mu_x, y - mu_y
    U, d, Vt = np.linalg.svd(yc.T @ xc / x.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = np.trace(np.diag(d) @ S) / ((xc ** 2).sum() / x.shape[0]) if with_scale else 1.0
    return R, mu_y - c * R @ mu_x, c


def ate_rmse(est_p, gt_p, align=True, with_scale=False):
    """Absolute trajectory error RMSE after optional Umeyama alignment."""
    est_p = np.asarray(est_p, float)
    gt_p = np.asarray(gt_p, float)
    if align:
        R, t, c = umeyama_alignment(est_p, gt_p, with_scale)
        est_p = (c * (R @ est_p.T)).T + t
    return float(np.sqrt(((est_p - gt_p) ** 2).sum(axis=1).mean()))
