"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
marginalization (port of orb_slam2_tpu/ba/schur.py).

`ba_solve_dense` materializes the reduced camera system with gathers, a
one-hot einsum and one matmul per point chunk and solves it directly;
`ba_solve` is the matrix-free PCG form for large camera counts.  The JAX
`while_loop` / `fori_loop` / `scan` become Python loops; the early stop of
the dense solver becomes a masked update, so the host never waits inside a
solve.

Float scatter-adds on CUDA sum with atomics in no fixed order.  The
segment sums of `ba_solve` therefore go through `SegmentSum`, which sorts
the rows of each segment once per problem into a padded table and reduces
it along one axis: the same sums, in the same order, every run.

Observation layout (R rows):
    obs_cam [R]    index into the camera array
    obs_pid [R]    point index
    obs_uv  [R, 2] measured pixel coords
    obs_ur  [R]    stereo right-u (-1 => mono)
    obs_w   [R]    information weight (inv sigma^2), 0 => inactive
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.core import lie


class BAProblem(NamedTuple):
    cam_pose: torch.Tensor   # [C, 7] SE3 Tcw
    cam_var: torch.Tensor    # [C] bool: optimize this camera?
    points: torch.Tensor     # [M, 3]
    pt_var: torch.Tensor     # [M] bool: optimize this point?
    obs_cam: torch.Tensor    # [R]
    obs_pid: torch.Tensor    # [R]
    obs_uv: torch.Tensor     # [R, 2]
    obs_ur: torch.Tensor     # [R]
    obs_w: torch.Tensor      # [R]
    K: torch.Tensor          # [4]
    bf: float


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor       # [R] final per-obs chi2
    inlier: torch.Tensor     # [R] chi2 <= threshold & active
    lam: torch.Tensor        # final LM damping (chunked resume)


def _residuals(prob: BAProblem, cam_pose, points):
    """e [R, 3], Jc [R, 3, 6], Jp [R, 3, 3] for all observations."""
    T = cam_pose[prob.obs_cam]
    pw = points[prob.obs_pid]
    q = T[:, :4]
    pc = lie.quat_rotate(q, pw) + T[:, 4:7]
    x, y = pc[:, 0], pc[:, 1]
    z = torch.clamp(pc[:, 2], min=1e-6)
    fx, fy, cx, cy = prob.K[0], prob.K[1], prob.K[2], prob.K[3]
    u = fx * x / z + cx
    v = fy * y / z + cy
    is_st = prob.obs_ur >= 0
    ur = u - prob.bf / z
    e = torch.stack([prob.obs_uv[:, 0] - u, prob.obs_uv[:, 1] - v,
                     torch.where(is_st, prob.obs_ur - ur, 0.0)], -1)
    iz = 1.0 / z
    iz2 = iz * iz
    zeros = torch.zeros_like(z)
    du = torch.stack([fx * iz, zeros, -fx * x * iz2], -1)
    dv = torch.stack([zeros, fy * iz, -fy * y * iz2], -1)
    dur = du + torch.stack([zeros, zeros, prob.bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(is_st[:, None], dur, 0.0)], 1)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        e.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -lie.hat(pc)], -1)          # [R, 3, 6]
    Jc = -torch.bmm(dproj, dpc_dxi)
    Jp = -torch.bmm(dproj, lie.quat_to_matrix(q))
    return e, Jc, Jp


def _inv3x3(A):
    """Batched closed-form 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    adj = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33], -1)
    return adj.reshape(A.shape) * inv_det[..., None, None]


def _huber_w(chi2, delta2):
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _chol3x3(A):
    """Batched closed-form Cholesky of PSD 3x3 blocks; zero blocks -> 0."""
    eps = 1e-12
    l11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=0.0) + eps)
    l21 = A[..., 1, 0] / l11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=0.0) + eps)
    l31 = A[..., 2, 0] / l11
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=0.0) + eps)
    z = torch.zeros_like(l11)
    L = torch.stack([torch.stack([l11, z, z], -1),
                     torch.stack([l21, l22, z], -1),
                     torch.stack([l31, l32, l33], -1)], -2)
    nz = torch.abs(A).sum((-1, -2)) > 1e-10
    return torch.where(nz[..., None, None], L, 0.0)


class SegmentSum:
    """Deterministic segment sum over the active rows of a problem.

    Built once per problem (one host read: the widest segment): the active
    rows are stably sorted by segment id into a padded [n, width] table of
    row indices.  Inactive rows carry weight 0 and contribute exact zeros,
    so leaving them out changes no sum."""

    def __init__(self, ids: torch.Tensor, active: torch.Tensor, n: int):
        rows = torch.nonzero(active).reshape(-1)
        seg = ids[rows].long()
        seg_sorted, order = torch.sort(seg, stable=True)
        counts = torch.bincount(seg, minlength=n)
        width = max(int(counts.max()) if rows.numel() else 0, 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(seg.numel(), device=ids.device) - starts[seg_sorted]
        self.R = ids.shape[0]
        self.table = torch.full((n, width), self.R, dtype=torch.int64,
                                device=ids.device)
        self.table[seg_sorted, rank] = rows[order]

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        padded = torch.cat([vals, torch.zeros_like(vals[:1])])
        return padded[self.table].sum(1)


# relative robust-cost improvement below which the dense LM stops early
DENSE_STOP_TOL = 1e-3


def ba_solve_dense(prob: BAProblem, pt_obs_r: torch.Tensor, n_per_cam: int,
                   n_outer: int = 10, huber_delta2: float = 5.991,
                   use_huber: bool = True, lam0=1e-4,
                   chi2_th_mono: float = 5.991, chi2_th_stereo: float = 7.815,
                   chunk: int = 2048) -> BAResult:
    """LM with an explicitly materialized Schur reduced camera system

        S = Hcc + lam I - sum_p W_p (Hpp_p + lam I)^-1 W_p^T

    built from per-point whitened camera blocks (S_corr = G^T G) and solved
    directly.  Observations are camera-major (obs_cam = repeat(arange(C),
    n_per_cam)); `pt_obs_r` [P, D] lists each point's observation rows (-1
    none); obs_w is nonzero only for rows listed there."""
    dev = prob.points.device
    C = prob.cam_pose.shape[0]
    P = prob.points.shape[0]
    assert P % chunk == 0 or P < chunk, (P, chunk)
    delta2 = torch.where(prob.obs_ur >= 0,
                         huber_delta2 * chi2_th_stereo / chi2_th_mono,
                         huber_delta2)
    act_pd = pt_obs_r >= 0
    rs = pt_obs_r.long().clamp(min=0)
    obs_cam_pd = torch.where(act_pd, prob.obs_cam[rs], C)
    n_chunks = max(P // chunk, 1)
    csz = min(chunk, P)
    cam_ids = torch.arange(C, device=dev)
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    var6 = prob.cam_var.repeat_interleave(6)
    fixed_diag = torch.diag(torch.where(var6, 0.0, 1.0))
    var_mask = var6[:, None] & var6[None, :]

    def seg_cam(vals):
        return vals.reshape((C, n_per_cam) + vals.shape[1:]).sum(1)

    def seg_pt(vals):
        g = vals[rs]
        mask = act_pd.reshape(act_pd.shape + (1,) * (vals.dim() - 1))
        return torch.where(mask, g, 0.0).sum(1)

    def chi2_fn(cam_pose, points):
        e, _, _ = _residuals(prob, cam_pose, points)
        return torch.sum(e * e, -1) * prob.obs_w

    def lm_step(cam_pose, points, lam):
        e, Jc, Jp = _residuals(prob, cam_pose, points)
        chi2 = torch.sum(e * e, -1) * prob.obs_w
        w_rob = _huber_w(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w = prob.obs_w * w_rob
        Jcw = Jc * w[:, None, None]
        Hcc = seg_cam(torch.bmm(Jcw.transpose(1, 2), Jc))       # [C, 6, 6]
        bc = seg_cam(torch.einsum('rij,ri->rj', Jcw, e))
        Jpw = Jp * w[:, None, None]
        Hpp = seg_pt(torch.bmm(Jpw.transpose(1, 2), Jp))        # [P, 3, 3]
        bp = seg_pt(torch.einsum('rij,ri->rj', Jpw, e))
        U = torch.bmm(Jcw.transpose(1, 2), Jp)                  # [R, 6, 3]

        Hpp_inv = _inv3x3(Hpp + lam * eye3)
        Hpp_inv = torch.where(prob.pt_var[:, None, None], Hpp_inv, 0.0)
        L = _chol3x3(Hpp_inv)
        Z = torch.bmm(U, L[prob.obs_pid])                       # [R, 6, 3]
        Z_pd = torch.where(act_pd[..., None, None], Z[rs], 0.0)

        S_corr = torch.zeros((C * 6, C * 6), device=dev)
        for i in range(n_chunks):
            oc = obs_cam_pd[i * csz:(i + 1) * csz]
            zz = Z_pd[i * csz:(i + 1) * csz]
            onehot = (oc[..., None] == cam_ids).to(torch.float32)
            G = torch.einsum('pdc,pdjl->plcj', onehot, zz)
            Gm = G.reshape(-1, C * 6)
            S_corr = S_corr + Gm.T @ Gm

        y = torch.einsum('pkl,pl->pk', Hpp_inv, bp)
        yb = torch.einsum('rjk,rk->rj', U, y[prob.obs_pid])
        rhs = bc - seg_cam(yb)
        rhs = torch.where(prob.cam_var[:, None], rhs, 0.0)

        Hcc_big = torch.zeros((C, 6, C, 6), device=dev)
        Hcc_big[cam_ids, :, cam_ids, :] = Hcc + lam * eye6
        S = Hcc_big.reshape(C * 6, C * 6) - S_corr
        S = torch.where(var_mask, S, 0.0) + fixed_diag
        dx = torch.linalg.solve_ex(S, -rhs.reshape(-1))[0].reshape(C, 6)
        dx = torch.where(prob.cam_var[:, None], dx, 0.0)

        xg = dx[obs_cam_pd.clamp(0, C - 1)]
        U_pd = torch.where(act_pd[..., None, None], U[rs], 0.0)
        s = torch.einsum('pdjl,pdj->pl', U_pd, xg)
        dp = torch.einsum('pkl,pl->pk', Hpp_inv, -bp - s)
        dp = torch.where(prob.pt_var[:, None], dp, 0.0)

        new_cam = lie.se3_retract(cam_pose, dx)
        new_cam = torch.where(prob.cam_var[:, None], new_cam, cam_pose)
        new_points = points + dp
        old_cost = torch.sum(chi2 * w_rob)
        new_chi2 = chi2_fn(new_cam, new_points)
        new_rob = _huber_w(new_chi2, delta2) if use_huber else 1.0
        new_cost = torch.sum(new_chi2 * new_rob)
        ok = (new_cost < old_cost) & torch.all(torch.isfinite(new_cam)) & \
            torch.all(torch.isfinite(new_points))
        cam_pose = torch.where(ok, new_cam, cam_pose)
        points = torch.where(ok, new_points, points)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-9, 1e6)
        return cam_pose, points, lam, torch.where(ok, new_cost, old_cost), ok

    # early-stopping LM (stop once an accepted step improves the robust cost
    # by < 0.1% after the third iteration), as masked updates
    cam_pose, points = prob.cam_pose, prob.points
    lam = torch.as_tensor(lam0, dtype=torch.float32, device=dev)
    prev_cost = torch.tensor(float("inf"), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(n_outer):
        c2, p2, l2, cost_after, ok = lm_step(cam_pose, points, lam)
        run = ~done
        cam_pose = torch.where(run, c2, cam_pose)
        points = torch.where(run, p2, points)
        lam = torch.where(run, l2, lam)
        rel = (prev_cost - cost_after) / torch.clamp(prev_cost, min=1e-9)
        prev_cost = torch.where(run, cost_after, prev_cost)
        done = done | (ok & (i >= 2) & (rel < DENSE_STOP_TOL))

    chi2 = chi2_fn(cam_pose, points)
    th = torch.where(prob.obs_ur >= 0, chi2_th_stereo, chi2_th_mono)
    inlier = (chi2 <= th) & (prob.obs_w > 0)
    return BAResult(cam_pose=cam_pose, points=points, chi2=chi2,
                    inlier=inlier, lam=lam)


def ba_solve(prob: BAProblem, n_outer: int = 10, n_cg: int = 40,
             huber_delta2: float = 5.991, use_huber: bool = True,
             lam0=1e-4, chi2_th_mono: float = 5.991,
             chi2_th_stereo: float = 7.815) -> BAResult:
    """LM for `n_outer` iterations, each camera step solved by `n_cg`
    iterations of block-Jacobi preconditioned CG on the matrix-free Schur
    system S x = (Hcc + lam I) x - W Hpp^-1 W^T x."""
    dev = prob.points.device
    C = prob.cam_pose.shape[0]
    M = prob.points.shape[0]
    delta2 = torch.where(prob.obs_ur >= 0,
                         huber_delta2 * chi2_th_stereo / chi2_th_mono,
                         huber_delta2)
    active = prob.obs_w > 0
    seg_cam = SegmentSum(prob.obs_cam, active, C)
    seg_pt = SegmentSum(prob.obs_pid, active, M)
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    cvar = prob.cam_var[:, None]

    def chi2_fn(cam_pose, points):
        e, _, _ = _residuals(prob, cam_pose, points)
        return torch.sum(e * e, -1) * prob.obs_w

    def lm_step(cam_pose, points, lam):
        e, Jc, Jp = _residuals(prob, cam_pose, points)
        chi2 = torch.sum(e * e, -1) * prob.obs_w
        w_rob = _huber_w(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w = prob.obs_w * w_rob
        Jcw = Jc * w[:, None, None]
        Hcc = seg_cam(torch.bmm(Jcw.transpose(1, 2), Jc))
        bc = seg_cam(torch.einsum('rij,ri->rj', Jcw, e))
        Jpw = Jp * w[:, None, None]
        Hpp = seg_pt(torch.bmm(Jpw.transpose(1, 2), Jp))
        bp = seg_pt(torch.einsum('rij,ri->rj', Jpw, e))
        Wb = torch.bmm(Jcw.transpose(1, 2), Jp)                 # [R, 6, 3]

        Hpp_inv = _inv3x3(Hpp + lam * eye3)
        Hpp_inv = torch.where(prob.pt_var[:, None, None], Hpp_inv, 0.0)
        yb = torch.einsum('rjk,rk->rj', Wb, torch.einsum(
            'mkl,ml->mk', Hpp_inv, bp)[prob.obs_pid])
        rhs = torch.where(cvar, bc - seg_cam(yb), 0.0)
        Hcc_d = Hcc + lam * eye6

        def schur_mv(x):
            x = torch.where(cvar, x, 0.0)
            hx = torch.einsum('cij,cj->ci', Hcc_d, x)
            u = torch.einsum('rjk,rj->rk', Wb, x[prob.obs_cam])
            s = torch.einsum('mkl,ml->mk', Hpp_inv, seg_pt(u))
            t = torch.einsum('rjk,rk->rj', Wb, s[prob.obs_pid])
            return torch.where(cvar, hx - seg_cam(t), 0.0)

        Pinv = torch.linalg.inv_ex(Hcc_d + eye6 * 1e-8)[0]
        Pinv = torch.where(prob.cam_var[:, None, None], Pinv, 0.0)
        precond = lambda r: torch.einsum('cij,cj->ci', Pinv, r)

        b = -rhs
        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(n_cg):
            Ap = schur_mv(p)
            pAp = torch.sum(p * Ap)
            alpha = rz / torch.where(torch.abs(pAp) > 1e-20, pAp,
                                     torch.full_like(pAp, 1e-20))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz,
                                        torch.full_like(rz, 1e-20))
            p = z + beta * p
            rz = rz_new
        dx_cam = x

        wx = torch.einsum('rjk,rj->rk', Wb, dx_cam[prob.obs_cam])
        dp = torch.einsum('mkl,ml->mk', Hpp_inv, -bp - seg_pt(wx))
        dp = torch.where(prob.pt_var[:, None], dp, 0.0)
        new_cam = lie.se3_retract(cam_pose, dx_cam)
        new_cam = torch.where(cvar, new_cam, cam_pose)
        new_points = points + dp
        old_cost = torch.sum(chi2 * w_rob)
        new_chi2 = chi2_fn(new_cam, new_points)
        new_rob = _huber_w(new_chi2, delta2) if use_huber else 1.0
        new_cost = torch.sum(new_chi2 * new_rob)
        ok = (new_cost < old_cost) & torch.all(torch.isfinite(new_cam)) & \
            torch.all(torch.isfinite(new_points))
        cam_pose = torch.where(ok, new_cam, cam_pose)
        points = torch.where(ok, new_points, points)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-9, 1e6)
        return cam_pose, points, lam

    cam_pose, points = prob.cam_pose, prob.points
    lam = torch.as_tensor(lam0, dtype=torch.float32, device=dev)
    for _ in range(n_outer):
        cam_pose, points, lam = lm_step(cam_pose, points, lam)

    chi2 = chi2_fn(cam_pose, points)
    th = torch.where(prob.obs_ur >= 0, chi2_th_stereo, chi2_th_mono)
    inlier = (chi2 <= th) & (prob.obs_w > 0)
    return BAResult(cam_pose=cam_pose, points=points, chi2=chi2,
                    inlier=inlier, lam=lam)
