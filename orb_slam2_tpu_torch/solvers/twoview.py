"""Monocular two-view initialization: batched H/F RANSAC + motion recovery
(port of orb_slam2_tpu/solvers/twoview.py).

`initialize` takes the RANSAC sample index sets as an argument, so a test
can feed the same sets to this port and to the JAX package (whose samples
come from `jax.random`, a stream torch cannot reproduce).  `sample_sets`
draws them with an explicit `torch.Generator`; `sets_from_uniform` builds
them from given uniform draws, which is how callers whose valid mask is
computed inside (relocalisation, loop verification) take JAX's samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.config import InitConfig
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.solvers import triangulate as tri


class TwoViewResult(NamedTuple):
    ok: torch.Tensor       # bool
    T21: torch.Tensor      # [7] frame 2 w.r.t. frame 1 (cam1 = world)
    points: torch.Tensor   # [N, 3]
    good: torch.Tensor     # [N] bool
    used_h: torch.Tensor   # bool


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Zero mean, unit mean absolute deviation per axis (reference
    Initializer::Normalize).  Returns (normalized pts, 3x3 transform)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    dev = (torch.abs(pts - mean) * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    pn = (pts - mean) * s
    T = torch.eye(3, device=pts.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return pn, T


def sets_from_uniform(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[iters, k] indices among valid entries from uniform draws u
    [iters, k]: slot j of each set takes the j-th of k equal strata of the
    valid range (JAX `_sample_sets` given the same draws)."""
    n = valid.shape[0]
    k = u.shape[-1]
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    nv = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    strat = (u + torch.arange(k, device=valid.device)) / k
    idx = torch.clamp((strat * nv).to(torch.int64), 0, n - 1)
    return order[idx]


def sample_sets(gen: torch.Generator, valid: torch.Tensor, iters: int,
                k: int = 8) -> torch.Tensor:
    """`sets_from_uniform` with draws from `gen`."""
    u = torch.rand((iters, k), generator=gen, device=valid.device)
    return sets_from_uniform(u, valid)


def _homography_dlt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[S, 8, 2] point sets -> [S, 3, 3] homographies (p2 ~ H p1)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([rows_a, rows_b], dim=-2)                  # [S, 16, 9]
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    return vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _fundamental_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[S, 8, 2] -> [S, 3, 3] rank-2 fundamental matrices (x2^T F x1 = 0)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    -1)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    Fm = vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    u, s, vt2 = torch.linalg.svd(Fm)
    s = s.clone()
    s[..., 2] = 0.0
    return u @ (s[..., :, None] * vt2)


def _score_h(H, Hinv, p1, p2, valid, sigma: float, th: float):
    """Reference CheckHomography: (score [S], inliers [S, N])."""
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(Hm, src, dst):
        ph = torch.cat([src, torch.ones_like(src[..., :1])], -1)
        q = torch.einsum('sij,nj->sni', Hm, ph)
        q = q[..., :2] / torch.where(torch.abs(q[..., 2:]) > 1e-12,
                                     q[..., 2:], torch.full_like(q[..., 2:],
                                                                 1e-12))
        return torch.sum((dst[None] - q) ** 2, -1)

    chi1 = transfer(Hinv, p2, p1) * inv_s2
    chi2 = transfer(H, p1, p2) * inv_s2
    ok = (chi1 < th) & (chi2 < th) & valid[None]
    score = torch.where(valid[None] & (chi1 < th), th - chi1, 0.0) + \
        torch.where(valid[None] & (chi2 < th), th - chi2, 0.0)
    return score.sum(-1), ok


def _score_f(Fm, p1, p2, valid, sigma: float, th: float, th_score: float):
    """Reference CheckFundamental: (score [S], inliers [S, N])."""
    inv_s2 = 1.0 / (sigma * sigma)
    ph1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    ph2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    l2 = torch.einsum('sij,nj->sni', Fm, ph1)
    l1 = torch.einsum('sji,nj->sni', Fm, ph2)
    d2 = torch.einsum('ni,sni->sn', ph2, l2) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.einsum('ni,sni->sn', ph1, l1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    chi1 = d1 * inv_s2
    chi2 = d2 * inv_s2
    ok = (chi1 < th) & (chi2 < th) & valid[None]
    score = torch.where(valid[None] & (chi2 < th), th_score - chi2, 0.0) + \
        torch.where(valid[None] & (chi1 < th), th_score - chi1, 0.0)
    return score.sum(-1), ok


def _check_rt(R, t, K, uv1, uv2, valid, sigma2_th: float):
    """Reference CheckRT batched over hypotheses [Hy] and points [N].
    Returns (n_good [Hy], parallax_deg [Hy], points [Hy, N, 3], good)."""
    T1 = lie.se3_identity(device=R.device)
    T2 = lie.se3_from_Rt(R, t)                                # [Hy, 7]
    xn1 = (uv1 - K[2:4]) / K[:2]
    xn2 = (uv2 - K[2:4]) / K[:2]
    pw = tri.triangulate_dlt(T1[None, None], T2[:, None], xn1[None],
                             xn2[None])                       # [Hy, N, 3]
    finite = torch.all(torch.isfinite(pw), -1)
    c1 = torch.zeros(3, device=R.device)
    c2 = -lie.quat_rotate(lie.quat_conj(lie.se3_q(T2)), lie.se3_t(T2))
    cosp = tri.parallax_cos(c1, c2[:, None], pw)
    z1 = tri.depth_in(T1, pw)
    z2 = tri.depth_in(T2[:, None], pw)
    e1 = tri.reprojection_error(T1, K, pw, uv1[None])
    e2 = tri.reprojection_error(T2[:, None], K, pw, uv2[None])
    low_parallax = cosp > 0.99998
    good = (valid & finite & ~low_parallax &
            (z1 > 0) & (z2 > 0) & (e1 < sigma2_th) & (e2 < sigma2_th))
    n_good = torch.sum(good.to(torch.int32), -1)
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1)[0]
    idx = torch.clamp(n_good - 1, min=0).clamp(max=49).long()
    par = torch.rad2deg(torch.arccos(torch.clamp(
        torch.gather(cos_sorted, 1, idx[:, None])[:, 0], -1.0, 1.0)))
    par = torch.where(n_good > 0, par, 0.0)
    return n_good, par, pw, good


def _decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t) candidate motions (Initializer.cc:909-929)."""
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]], device=E.device)
    R1 = u @ W @ vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = u @ W.T @ vt
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _decompose_h(H: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD homography decomposition -> 8 (R, t) hypotheses
    (Initializer.cc:584-686)."""
    dev = H.device
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    Km = torch.stack([torch.stack([K[0], zero, K[2]]),
                      torch.stack([zero, K[1], K[3]]),
                      torch.stack([zero, zero, one])])
    Kinv = torch.stack([torch.stack([1.0 / K[0], zero, -K[2] / K[0]]),
                        torch.stack([zero, 1.0 / K[1], -K[3] / K[1]]),
                        torch.stack([zero, zero, one])])
    A = Kinv @ H @ Km
    U, d, Vt = torch.linalg.svd(A)
    V = Vt.T
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / den)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / den)
    sg = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
    sg3 = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    sgs = torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev)
    x1s, x3s = sg * aux1, sg3 * aux3

    Rs, ts = [], []
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    stheta = sgs * aux_st
    for i in range(4):
        Rp = torch.eye(3, device=dev)
        Rp[0, 0], Rp[0, 2] = ctheta, -stheta[i]
        Rp[2, 0], Rp[2, 2] = stheta[i], ctheta
        Rs.append(s * U @ Rp @ Vt)
        t = U @ (torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sphi = sgs * aux_sp
    for i in range(4):
        Rp = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=dev))
        Rp[0, 0], Rp[0, 2] = cphi, sphi[i]
        Rp[2, 0], Rp[2, 2] = sphi[i], -cphi
        Rs.append(s * U @ Rp @ Vt)
        t = U @ (torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def initialize(K: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
               valid: torch.Tensor, sets: torch.Tensor,
               cfg: InitConfig = InitConfig()) -> TwoViewResult:
    """Two-view bootstrap from matched undistorted pixel coords.

    uv1, uv2: [N, 2] row-aligned pairs; valid: [N] bool; sets: [iters, 8]
    RANSAC sample indices (see `sample_sets`)."""
    sigma = cfg.sigma
    p1n, T1n = _normalize(uv1, valid)
    p2n, T2n = _normalize(uv2, valid)
    T2inv = torch.linalg.inv(T2n)
    s1 = p1n[sets]
    s2 = p2n[sets]

    Hn = _homography_dlt(s1, s2)
    H = T2inv @ Hn @ T1n
    Hinv = torch.linalg.inv_ex(H)[0]
    score_h, inl_h = _score_h(H, Hinv, uv1, uv2, valid, sigma,
                              cfg.h_inlier_th)
    Fn = _fundamental_8pt(s1, s2)
    Fm = T2n.T @ Fn @ T1n
    score_f, inl_f = _score_f(Fm, uv1, uv2, valid, sigma, cfg.f_inlier_th,
                              cfg.score_th)

    bh = torch.argmax(score_h)
    bf = torch.argmax(score_f)
    SH, SF = score_h[bh], score_f[bf]
    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_h = RH > cfg.rh_homography_th

    sigma2_th = 4.0 * sigma * sigma
    f_valid = inl_f[bf]
    h_valid = inl_h[bh]
    n_f = torch.sum(f_valid.to(torch.int32))
    n_h = torch.sum(h_valid.to(torch.int32))
    min_good = torch.clamp((cfg.cheirality_frac * n_f).to(torch.int32),
                           min=cfg.min_triangulated)

    dev = uv1.device
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    Km = torch.stack([torch.stack([K[0], zero, K[2]]),
                      torch.stack([zero, K[1], K[3]]),
                      torch.stack([zero, zero, one])])
    E = Km.T @ Fm[bf] @ Km
    R1, R2, t = _decompose_e(E)
    f_R = torch.stack([R1, R1, R2, R2])
    f_t = torch.stack([t, -t, t, -t])
    h_R, h_t = _decompose_h(H[bh], K)

    Rall = torch.cat([f_R, h_R], 0)                          # [12, 3, 3]
    tall = torch.cat([f_t, h_t], 0)
    vall = torch.cat([f_valid.expand(4, -1), h_valid.expand(8, -1)], 0)
    ng, par, pts, good = _check_rt(Rall, tall, K, uv1, uv2, vall, sigma2_th)
    f_ng, h_ng = ng[:4], ng[4:]
    f_par, h_par = par[:4], par[4:]

    f_max = torch.amax(f_ng)
    f_similar = torch.sum((f_ng > cfg.unique_winner_frac * f_max
                           ).to(torch.int32))
    f_win = torch.argmax(f_ng)
    f_ok = ((f_max >= min_good) & (f_similar == 1) &
            (f_par[f_win] > cfg.min_parallax_deg))

    h_sorted = torch.sort(h_ng)[0]
    h_best, h_second = h_sorted[-1], h_sorted[-2]
    h_win = torch.argmax(h_ng)
    h_ok = ((h_second < cfg.second_best_frac * h_best) &
            (h_par[h_win] > cfg.min_parallax_deg) &
            (h_best > cfg.min_triangulated) &
            (h_best > cfg.cheirality_frac * n_h))

    win = torch.where(use_h, 4 + h_win, f_win)
    ok = torch.where(use_h, h_ok, f_ok)
    T21 = lie.se3_from_Rt(Rall[win], tall[win])
    return TwoViewResult(ok=ok, T21=T21, points=pts[win], good=good[win],
                         used_h=use_h)
