"""Trajectory evaluation: ATE RMSE with SE3/Sim3 alignment.

Equivalent of the TUM RGB-D benchmark's `evaluate_ate.py` that the reference
delegates to (System.h:100): Umeyama alignment (with scale for monocular,
where scale is unobservable) then RMSE over translation errors.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """Least-squares similarity transform mapping src -> dst ([N, 3] each).
    Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_twc: np.ndarray, gt_twc: np.ndarray,
             align_scale: bool = True) -> float:
    """ATE RMSE between aligned trajectories given as [F, 7] (wxyz quat + t)
    or [F, 3] translation arrays."""
    p_est = est_twc[:, 4:7] if est_twc.shape[1] == 7 else est_twc
    p_gt = gt_twc[:, 4:7] if gt_twc.shape[1] == 7 else gt_twc
    assert len(p_est) == len(p_gt) and len(p_est) >= 3
    s, R, t = umeyama(p_est, p_gt, align_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = aligned - p_gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def match_timestamps(est_t: np.ndarray, gt_t: np.ndarray, max_dt=0.02):
    """Indices (ie, ig) of timestamp-associated pairs."""
    ie, ig = [], []
    j = 0
    for i, t in enumerate(est_t):
        j = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[j] - t) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.asarray(ie), np.asarray(ig)
