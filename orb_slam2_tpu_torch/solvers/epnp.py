"""EPnP + RANSAC absolute pose from 3D-2D correspondences (port of
orb_slam2_tpu/solvers/epnp.py).

Replaces the reference's `PnPsolver` (the modified Lepetit EPnP): 4 control
points from PCA, barycentric coordinates, the 12x12 M^T M eigen-system, the
beta-scaled null-vector solutions with Gauss-Newton refinement on the
control-point distance constraints, and Horn alignment for (R, t).  Every
function takes leading batch dimensions, so all RANSAC samples solve at
once (JAX `vmap`s the single solve).

`eigh` returns eigenvectors whose signs, and order among equal eigenvalues,
depend on the library; everything downstream (the betas, the depth-sign
flip, Horn) is invariant to them, so only the recovered pose is compared
with JAX's.  `pnp_ransac` takes its sample index sets as an argument (see
`twoview.sample_sets`), so a test can hand the port JAX's samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.solvers.sim3 import _eigh, horn_sim3

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


class PnPResult(NamedTuple):
    ok: torch.Tensor
    T: torch.Tensor          # [7] Tcw
    inliers: torch.Tensor    # [N]
    n_inliers: torch.Tensor


def _pair_diff(c: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] points -> [..., 6, 3] differences of the 6 pairs."""
    i = torch.tensor([p[0] for p in _PAIRS], device=c.device)
    j = torch.tensor([p[1] for p in _PAIRS], device=c.device)
    return c[..., i, :] - c[..., j, :]


def _dist2_pairs(c: torch.Tensor) -> torch.Tensor:
    d = _pair_diff(c)
    return torch.sum(d * d, dim=-1)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD with numpy's cut-off
    (singular values below eps x max(m, n) x the largest are dropped), as
    `jnp.linalg.lstsq`; the same on the CPU and the card, where torch's own
    lstsq only takes full-rank systems.  A system with a NaN or inf gives
    NaN, as in JAX (torch's SVD may raise on it instead)."""
    ok = torch.all(torch.isfinite(A), dim=(-1, -2)) & \
        torch.all(torch.isfinite(b), dim=-1)
    U, s, Vh = torch.linalg.svd(torch.where(ok[..., None, None], A, 0.0),
                                full_matrices=False)
    eps = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    keep = s > eps * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    utb = torch.einsum('...mk,...m->...k', U, torch.where(ok[..., None], b,
                                                           0.0))
    x = torch.einsum('...kn,...k->...n', Vh, s_inv * utb)
    return torch.where(ok[..., None], x, float("nan"))


def _control_points(pw: torch.Tensor) -> torch.Tensor:
    """[..., n, 3] -> world control points [..., 4, 3] (centroid + PCA)."""
    c0 = torch.mean(pw, dim=-2)
    x = pw - c0[..., None, :]
    cov = x.transpose(-1, -2) @ x / pw.shape[-2]
    w, v = _eigh(cov)
    k = torch.sqrt(torch.clamp(w, min=1e-9))
    cps = c0[..., None, :] + v.transpose(-1, -2) * k[..., :, None]
    return torch.cat([c0[..., None, :], cps], dim=-2)


def _barycentric(cw: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """alphas [..., n, 4] with pw = sum_j alpha_j cw_j, sum alpha = 1."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)     # [..., 3, 3]
    Binv = torch.linalg.inv_ex(
        B + 1e-9 * torch.eye(3, device=pw.device))[0]
    a123 = (pw - cw[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _betas(V: torch.Tensor, dw2: torch.Tensor) -> list:
    """The four initial beta vectors [..., 4] (PnPsolver
    compute_betas_approx_1/2/3 and the single-null-vector case)."""
    dv = [_pair_diff(V[..., k, :, :]) for k in range(4)]        # [..., 6, 3]
    dot = lambda a, b: torch.sum(a * b, -1)
    zero = torch.zeros_like(dw2[..., 0])
    # one null vector
    dc2 = _dist2_pairs(V[..., 0, :, :])
    b = torch.sum(torch.sqrt(dc2 * dw2), -1) / torch.clamp(
        torch.sum(dc2, -1), min=1e-12)
    out = [torch.stack([b, zero, zero, zero], -1)]
    # two: L [b11, b12, b22] = rho
    L = torch.stack([dot(dv[0], dv[0]), 2 * dot(dv[0], dv[1]),
                     dot(dv[1], dv[1])], -1)
    x = _lstsq(L, dw2)
    b1 = torch.sqrt(torch.clamp(torch.abs(x[..., 0]), min=1e-12))
    b2 = torch.sqrt(torch.clamp(torch.abs(x[..., 2]), min=1e-12)) * \
        torch.sign(x[..., 1]) * torch.sign(x[..., 0])
    out.append(torch.stack([b1, b2, zero, zero], -1))
    # three: L [b11 b12 b22 b13 b23] = rho
    L = torch.stack([dot(dv[0], dv[0]), 2 * dot(dv[0], dv[1]),
                     dot(dv[1], dv[1]), 2 * dot(dv[0], dv[2]),
                     2 * dot(dv[1], dv[2])], -1)
    x = _lstsq(L, dw2)
    b1 = torch.sqrt(torch.clamp(torch.abs(x[..., 0]), min=1e-12))
    b2 = torch.sqrt(torch.clamp(torch.abs(x[..., 2]), min=1e-12)) * \
        torch.sign(x[..., 1]) * torch.sign(x[..., 0])
    b3 = x[..., 3] / torch.clamp(b1, min=1e-12)
    out.append(torch.stack([b1, b2, b3, zero], -1))
    # four: L [b11 b12 b13 b14] = rho
    L = torch.stack([dot(dv[0], dv[0]), 2 * dot(dv[0], dv[1]),
                     2 * dot(dv[0], dv[2]), 2 * dot(dv[0], dv[3])], -1)
    x = _lstsq(L, dw2)
    b1 = torch.sqrt(torch.clamp(torch.abs(x[..., 0]), min=1e-12)) * \
        torch.sign(x[..., 0])
    b1 = torch.where(b1 == 0, 1e-6, b1)
    out.append(torch.stack([torch.abs(b1), x[..., 1] / b1, x[..., 2] / b1,
                            x[..., 3] / b1], -1))
    return out


def _gauss_newton(betas: torch.Tensor, V: torch.Tensor, dw2: torch.Tensor,
                  iters: int = 5) -> torch.Tensor:
    """Refine betas on the 6 control-point distance residuals
    r(b) = |sum_k b_k dv_k|^2 - dw2, with dr/db_k = 2 d . dv_k."""
    dv = torch.stack([_pair_diff(V[..., k, :, :]) for k in range(4)], -3)
    for _ in range(iters):
        d = torch.einsum('...k,...kpi->...pi', betas, dv)        # [..., 6, 3]
        r = torch.sum(d * d, -1) - dw2
        J = 2.0 * torch.einsum('...pi,...kpi->...pk', d, dv)     # [..., 6, 4]
        betas = betas + _lstsq(J, -r)
    return betas


def epnp_solve(pw: torch.Tensor, uv: torch.Tensor, K: torch.Tensor,
               w: torch.Tensor = None) -> torch.Tensor:
    """EPnP over correspondences pw [..., n, 3], uv [..., n, 2] -> Tcw
    [..., 7].  w: optional per-row weight [..., n] (0 masks a row)."""
    if w is None:
        w = torch.ones(pw.shape[:-1], device=pw.device)
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    cw = _control_points(pw)
    alpha = _barycentric(cw, pw)                                 # [..., n, 4]
    u, v = uv[..., 0], uv[..., 1]
    z4 = torch.zeros_like(alpha)
    r1 = torch.cat([alpha * fx, z4, alpha * (cx - u)[..., None]], -1)
    r2 = torch.cat([z4, alpha * fy, alpha * (cy - v)[..., None]], -1)
    # columns [x1..x4, y1..y4, z1..z4] -> control-point-major [c1(xyz), ..]
    perm = torch.tensor([0, 4, 8, 1, 5, 9, 2, 6, 10, 3, 7, 11],
                        device=pw.device)
    M = torch.cat([r1, r2], -2)[..., perm]                     # [..., 2n, 12]
    wm = torch.cat([w, w], -1)[..., None]
    MtM = (M * wm).transpose(-1, -2) @ M
    eigv = _eigh(MtM)[1]
    V = eigv[..., :, :4].transpose(-1, -2).reshape(
        eigv.shape[:-2] + (4, 4, 3))            # 4 smallest null-ish vectors
    dw2 = _dist2_pairs(cw)

    Ts, costs = [], []
    for b0 in _betas(V, dw2):
        betas = _gauss_newton(b0, V, dw2)
        cc = torch.einsum('...k,...kij->...ij', betas, V)        # [..., 4, 3]
        pc = alpha @ cc
        sign = torch.sign(torch.sum(pc[..., 2] * w, -1) + 1e-12)
        cc = cc * sign[..., None, None]
        T = horn_sim3(cc, cw, fix_scale=True)[..., :7]
        pr = camera.project(K, lie.se3_apply(T[..., None, :], pw))
        Ts.append(T)
        costs.append(torch.sum(torch.sum((pr - uv) ** 2, -1) * w, -1))
    best = torch.argmin(torch.stack(costs, -1), dim=-1)          # [...]
    Ts = torch.stack(Ts, -2)                                     # [..., 4, 7]
    return torch.gather(Ts, -2, best[..., None, None].expand(
        best.shape + (1, 7)))[..., 0, :]


def pnp_ransac(sets: torch.Tensor, pw: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor, max_err2: torch.Tensor,
               min_inliers: int = 10) -> PnPResult:
    """Batched RANSAC EPnP (reference PnPsolver::iterate).

    sets: [iters, k] sample indices; max_err2: [N] per-point squared-pixel
    gate (th2 sigma^2)."""
    Ts = epnp_solve(pw[sets], uv[sets], K)                       # [iters, 7]

    def count(T):
        pc = lie.se3_apply(T[..., None, :], pw)
        err = torch.sum((camera.project(K, pc) - uv) ** 2, -1)
        return valid & (err < max_err2) & (pc[..., 2] > 0)

    inl = count(Ts)                                              # [iters, N]
    counts = torch.sum(inl.to(torch.int32), dim=1)
    best = torch.argmax(counts)
    # refine on the best inlier set with a weighted full solve
    T_ref = epnp_solve(pw, uv, K, w=(inl[best] & valid).to(torch.float32))
    inl_ref = count(T_ref)
    better = torch.sum(inl_ref.to(torch.int32)) >= counts[best]
    T_fin = torch.where(better, T_ref, Ts[best])
    inl_fin = torch.where(better, inl_ref, inl[best])
    n_in = torch.sum(inl_fin.to(torch.int32))
    return PnPResult(ok=n_in >= min_inliers, T=T_fin, inliers=inl_fin,
                     n_inliers=n_in)
