"""Sim3 / SE3 estimation between two keyframes from matched map points
(port of orb_slam2_tpu/solvers/sim3.py).

Horn's closed-form quaternion absolute orientation on 3-point samples,
RANSAC over all hypotheses at once with a two-way reprojection inlier check
(reference Sim3Solver.cc:166-328), and LM refinement of the relative Sim3
with paired forward/inverse projection residuals (Optimizer::OptimizeSim3,
Optimizer.cc:1046-1241).

`sim3_ransac` takes its sample index sets as an argument (see
`twoview.sample_sets`), so a test can hand the port JAX's samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from orb_slam2_tpu_torch.core import camera, lie


def _eigh(A: torch.Tensor):
    """`eigh` of symmetric [..., n, n] matrices.  A matrix with a NaN or
    inf is decomposed as the identity and its eigenvectors are NaN, as JAX
    returns them: torch's eigh raises on such input instead."""
    ok = torch.all(torch.isfinite(A), dim=(-1, -2))[..., None, None]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, v = torch.linalg.eigh(torch.where(ok, A, eye))
    return w, torch.where(ok, v, float("nan"))


class Sim3Result(NamedTuple):
    ok: torch.Tensor
    S12: torch.Tensor        # [8] Sim3 mapping cam2 coords into cam1
    inliers: torch.Tensor    # [N]
    n_inliers: torch.Tensor


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Closed-form similarity from aligned point sets [..., K, 3]: Sim3 S12
    with p1 ~ s R p2 + t (Horn 1987; Sim3Solver::ComputeSim3).  The
    rotation is the eigenvector of the largest eigenvalue of Horn's 4x4
    matrix; its sign is fixed by the quaternion normalization."""
    c1 = torch.mean(p1, dim=-2, keepdim=True)
    c2 = torch.mean(p2, dim=-2, keepdim=True)
    x1 = p1 - c1
    x2 = p2 - c2
    M = torch.einsum('...ki,...kj->...ij', x2, x1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    q = lie.quat_normalize(_eigh(N)[1][..., :, -1])
    rx2 = lie.quat_rotate(q[..., None, :], x2)
    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    else:
        num = torch.sum(x1 * rx2, dim=(-1, -2))
        den = torch.clamp(torch.sum(rx2 * rx2, dim=(-1, -2)), min=1e-12)
        s = num / den
    t = c1[..., 0, :] - s[..., None] * lie.quat_rotate(q, c2[..., 0, :])
    return torch.cat([q, t, s[..., None]], dim=-1)


def _two_way_err(S, K, p1, p2, uv1, uv2):
    """Squared reprojection errors of p2 through S into image 1 and of p1
    through S^-1 into image 2, for hypotheses S [..., 8]."""
    S21 = lie.sim3_inverse(S)
    q1 = camera.project(K, lie.sim3_apply(S[..., None, :], p2))
    q2 = camera.project(K, lie.sim3_apply(S21[..., None, :], p1))
    return torch.sum((q1 - uv1) ** 2, -1), torch.sum((q2 - uv2) ** 2, -1)


def sim3_ransac(sets: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                K: torch.Tensor, max_err1: torch.Tensor,
                max_err2: torch.Tensor, fix_scale: bool,
                min_inliers: int = 20) -> Sim3Result:
    """RANSAC Horn on matched camera-frame points.

    sets: [iters, 3] sample indices; p1, p2: [N, 3] matched points in
    camera frames 1 / 2; uv1, uv2: [N, 2] their pixels; max_err*: per-point
    chi^2 gates (9.210 sigma^2, Sim3Solver.cc:87-88)."""
    S = horn_sim3(p1[sets], p2[sets], fix_scale)         # [iters, 8]
    e1, e2 = _two_way_err(S, K, p1, p2, uv1, uv2)        # [iters, N]
    inl = valid & (e1 < max_err1) & (e2 < max_err2)
    counts = torch.sum(inl.to(torch.int32), dim=1)
    best = torch.argmax(counts)
    n_in = counts[best]
    return Sim3Result(ok=n_in >= min_inliers, S12=S[best], inliers=inl[best],
                      n_inliers=n_in)


def optimize_sim3(S12: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                  K: torch.Tensor, inv_sigma1: torch.Tensor,
                  inv_sigma2: torch.Tensor, fix_scale: bool,
                  th2: float = 10.0, iters: int = 10):
    """LM on the 7-dof relative Sim3 with paired projection edges and a
    mid-way outlier rejection (Optimizer.cc:1175-1192).  Jacobians by
    forward-mode autodiff of the retraction, as JAX's `jacfwd`.

    Returns (S12, n_inliers, inlier mask)."""
    dev = p1.device
    w1 = torch.sqrt(inv_sigma1)[:, None]
    w2 = torch.sqrt(inv_sigma2)[:, None]

    def residuals(S):
        S21 = lie.sim3_inverse(S)
        q1 = camera.project(K, lie.sim3_apply(S[None], p2))
        q2 = camera.project(K, lie.sim3_apply(S21[None], p1))
        return (uv1 - q1) * w1, (uv2 - q2) * w2

    def chi2(S):
        r1, r2 = residuals(S)
        return torch.sum(r1 * r1, -1), torch.sum(r2 * r2, -1)

    def stacked(S):
        return torch.cat(residuals(S), 0)                 # [2N, 2]

    zero7 = torch.zeros(7, device=dev)
    eye7 = torch.eye(7, device=dev)
    free = torch.ones(7, device=dev)
    if fix_scale:
        free[6] = 0.0
    active = valid
    lam = torch.tensor(1e-3, device=dev)
    for i in range(iters):
        J = jacfwd(lambda xi: stacked(lie.sim3_retract(S12, xi)))(zero7)
        r = stacked(S12)
        a2 = torch.cat([active, active])
        w = a2.to(torch.float32)
        H = torch.einsum('nij,nik,n->jk', J, J, w)
        g = torch.einsum('nij,ni,n->j', J, r, w)
        # a fixed scale freezes its direction: H row/col 6 -> e_6, g_6 -> 0
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        g = g * free
        dx = torch.linalg.solve_ex(H + lam * eye7, -g)[0]
        S_new = lie.sim3_retract(S12, dx)
        c_old = torch.sum(torch.where(a2, torch.sum(r * r, -1), 0.0))
        rn = stacked(S_new)
        c_new = torch.sum(torch.where(a2, torch.sum(rn * rn, -1), 0.0))
        ok = (c_new < c_old) & torch.all(torch.isfinite(S_new))
        S12 = torch.where(ok, S_new, S12)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-9, 1e4)
        if i == iters // 2:
            c1, c2 = chi2(S12)
            active = valid & (c1 < th2) & (c2 < th2)

    c1, c2 = chi2(S12)
    inl = valid & (c1 < th2) & (c2 < th2)
    return S12, torch.sum(inl.to(torch.int32)), inl
