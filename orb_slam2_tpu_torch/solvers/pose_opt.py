"""Motion-only bundle adjustment (port of orb_slam2_tpu/solvers/pose_opt.py).

4 rounds x 10 Levenberg-Marquardt iterations over one SE3 pose with chi^2
inlier reclassification between rounds and the Huber kernel dropped for the
last round (reference Optimizer::PoseOptimization, Optimizer.cc:239-451).

The JAX `while_loop` stops a round once a step converged.  Here each round
runs its full iteration count with masked updates: after convergence the
carry is frozen, so the result is the same and the host never waits for
the device inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.config import BAConfig
from orb_slam2_tpu_torch.core import lie


class PoseOptResult(NamedTuple):
    T: torch.Tensor          # [7] optimized pose
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor
    chi2: torch.Tensor


def _residuals_jac(T, pw, obs_uv, obs_ur, K, bf, is_stereo):
    """Residuals [N, 3] (third = stereo u_R, zero for mono), Jacobians
    [N, 3, 6] of the left-multiplied exp-map parameterization."""
    q, t = lie.se3_q(T), lie.se3_t(T)
    pc = lie.quat_rotate(q, pw) + t
    x, y, z = pc[:, 0], pc[:, 1], torch.clamp(pc[:, 2], min=1e-6)
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    u = fx * x / z + cx
    v = fy * y / z + cy
    ur = u - bf / z
    e_u = obs_uv[:, 0] - u
    e_v = obs_uv[:, 1] - v
    e_r = torch.where(is_stereo, obs_ur - ur, 0.0)
    e = torch.stack([e_u, e_v, e_r], -1)

    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    dur = du + torch.stack([zero, zero, bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(is_stereo[:, None], dur, 0.0)], 1)
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device).expand(
        pw.shape[0], 3, 3)
    dpc = torch.cat([eye, -lie.hat(pc)], -1)               # [N, 3, 6]
    J = -torch.bmm(dproj, dpc)
    return e, J


def _huber_w(chi2, delta2):
    """Huber IRLS weight on the squared error (g2o RobustKernelHuber)."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_optimize(T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo,
                  K, bf, cfg: BAConfig = BAConfig()) -> PoseOptResult:
    """Optimize one camera pose against fixed 3D points.

    T0: [7]; pw: [N, 3]; obs_uv: [N, 2]; obs_ur: [N]; inv_sigma2: [N];
    valid: [N] bool; is_stereo: [N] bool."""
    dev = pw.device
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    delta2 = torch.where(is_stereo, cfg.huber_stereo ** 2, cfg.huber_mono ** 2)
    eye6 = torch.eye(6, device=dev)

    def chi2_of(T):
        e, _ = _residuals_jac(T, pw, obs_uv, obs_ur, K, bf, is_stereo)
        return torch.sum(e * e, -1) * inv_sigma2

    def lm_round(T, active, use_huber):
        act = active.to(torch.float32)
        lam = torch.tensor(cfg.lm_lambda_init, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(cfg.pose_opt_iters):
            e, J = _residuals_jac(T, pw, obs_uv, obs_ur, K, bf, is_stereo)
            chi2 = torch.sum(e * e, -1) * inv_sigma2
            w = _huber_w(chi2, delta2) if use_huber else torch.ones_like(chi2)
            wi = w * inv_sigma2 * act
            H = torch.einsum('nij,nik,n->jk', J, J, wi)
            g = torch.einsum('nij,ni,n->j', J, e, wi)
            total0 = torch.sum(chi2 * w * act)
            dx = torch.linalg.solve_ex(H + lam * eye6, -g)[0]
            T_new = lie.se3_retract(T, dx)
            c_new = chi2_of(T_new)
            w_new = _huber_w(c_new, delta2) if use_huber \
                else torch.ones_like(c_new)
            total1 = torch.sum(c_new * w_new * act)
            ok = (total1 < total0) & torch.all(torch.isfinite(T_new))
            run = ~done
            T = torch.where(run & ok, T_new, T)
            lam_next = torch.clamp(torch.where(ok, lam * 0.5,
                                               lam * cfg.lm_lambda_factor),
                                   1e-10, 1e6)
            lam = torch.where(run, lam_next, lam)
            rel = (total0 - total1) / torch.clamp(total0, min=1e-9)
            done = done | (ok & (rel < 1e-5) & (torch.sum(dx * dx) < 1e-10))
        return T

    active = valid
    T = T0
    for r in range(cfg.pose_opt_rounds):
        T = lm_round(T, active, r < cfg.pose_opt_rounds - 1)
        active = valid & (chi2_of(T) <= chi2_th)

    c = chi2_of(T)
    inliers = valid & (c <= chi2_th)
    return PoseOptResult(T=T, inliers=inliers,
                         n_inliers=torch.sum(inliers.to(torch.int32)),
                         chi2=torch.sum(torch.where(inliers, c, 0.0)))
