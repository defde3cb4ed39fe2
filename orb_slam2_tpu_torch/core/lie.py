"""SO3 / SE3 / Sim3 quaternion ops on batched tensors (port of
orb_slam2_tpu/core/lie.py).

Representations match the reference package:
* rotation: unit quaternion ``q = [w, x, y, z]``           ``[..., 4]``
* SE3:      ``T = [qw, qx, qy, qz, tx, ty, tz]`` (Tcw)     ``[..., 7]``
* Sim3:     ``S = [qw, qx, qy, qz, tx, ty, tz, s]``        ``[..., 8]``
Tangent vectors are ``[rho(3), phi(3)]`` (g2o ordering), with a trailing
``sigma = log s`` for Sim3.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.core import seqwise

_EPS = 1e-8


def _safe_norm(x, dim=-1, keepdim=False):
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=1e-24))


# ---------------------------------------------------------------------------
# Quaternion (SO3)
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = _safe_norm(q, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (Shepperd's method on
    all four candidates, best-conditioned one picked)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(qs, dim=-1)
    r = torch.sqrt(torch.clamp(
        torch.gather(qs, -1, case[..., None])[..., 0], min=_EPS))
    inv = 0.5 / r
    q0 = torch.stack([0.5 * r, (m21 - m12) * inv, (m02 - m20) * inv, (m10 - m01) * inv], -1)
    q1 = torch.stack([(m21 - m12) * inv, 0.5 * r, (m01 + m10) * inv, (m02 + m20) * inv], -1)
    q2 = torch.stack([(m02 - m20) * inv, (m01 + m10) * inv, 0.5 * r, (m12 + m21) * inv], -1)
    q3 = torch.stack([(m10 - m01) * inv, (m02 + m20) * inv, (m12 + m21) * inv, 0.5 * r], -1)
    qcands = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(qcands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion."""
    theta = _safe_norm(phi, keepdim=True)
    half = 0.5 * theta
    k = torch.where(theta > _EPS,
                    torch.sin(half) / torch.clamp(theta, min=_EPS),
                    torch.full_like(theta, 0.5))
    w = torch.cos(half)
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle [..., 3]."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    n = _safe_norm(v, keepdim=True)
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(n > _EPS, theta / torch.clamp(n, min=_EPS),
                    torch.full_like(n, 2.0))
    return k * v


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3, 3] of v [..., 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

def se3_identity(shape=(), device=None) -> torch.Tensor:
    T = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    T[..., 0].fill_(1.0)
    return T


def se3(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_normalize(q), t], dim=-1)


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return se3(matrix_to_quat(R), t)


def se3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., :4]


def se3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., 4:7]


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p_cam = R p + t."""
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A*B (apply B first)."""
    q = quat_mul(se3_q(A), se3_q(B))
    t = quat_rotate(se3_q(A), se3_t(B)) + se3_t(A)
    return se3(q, t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(se3_q(T))
    ti = -quat_rotate(qi, se3_t(T))
    return se3(qi, ti)


def se3_matrix(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] homogeneous matrix."""
    R = quat_to_matrix(se3_q(T))
    t = se3_t(T)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def _so3_left_jacobian(phi: torch.Tensor, per_seq: bool = False
                       ) -> torch.Tensor:
    """SO3 left Jacobian J_l(phi), [..., 3, 3] (`per_seq`: the leading
    axis is a sequence axis, see `se3_retract`)."""
    theta = _safe_norm(phi)
    th2 = theta * theta
    W = hat(phi)
    W2 = seqwise.each(lambda w: w @ w, W) if per_seq else W @ W
    small = theta < 1e-5
    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(th2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(th2 * theta, min=_EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(xi: torch.Tensor, per_seq: bool = False) -> torch.Tensor:
    """Tangent [..., 6] = [rho, phi] -> SE3 (t = J_l(phi) rho)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    J = _so3_left_jacobian(phi, per_seq)
    ein = seqwise.einsum if per_seq else torch.einsum
    t = ein('...ij,...j->...i', J, rho)
    return se3(q, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(se3_q(T))
    J = _so3_left_jacobian(phi)
    rho = torch.linalg.solve_ex(J, se3_t(T)[..., None])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_retract(T: torch.Tensor, xi: torch.Tensor,
                per_seq: bool = False) -> torch.Tensor:
    """Left-multiplied exp-map update exp(xi) * T (g2o VertexSE3Expmap).
    With `per_seq`, T [S, ..., 7] and xi [S, ..., 6] carry a sequence axis
    and the 3x3 products run once a sequence (`core.seqwise`), so that a
    sequence gets the bits of its S = 1 call."""
    return se3_compose(se3_exp(xi, per_seq), T)


# ---------------------------------------------------------------------------
# Sim3
# ---------------------------------------------------------------------------

def sim3_from_se3(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T, torch.ones_like(T[..., :1])], dim=-1)


# Scales are handled as [..., 1] slices: forward-mode autodiff
# (torch.func.jacfwd) gives float64 tangents to some ops between a 0-dim
# tensor and a Python float.
def sim3_q(S): return S[..., :4]
def sim3_t(S): return S[..., 4:7]
def sim3_s(S): return S[..., 7]


def sim3_apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p' = s R p + t  (g2o Sim3::map)."""
    return S[..., 7:8] * quat_rotate(sim3_q(S), p) + sim3_t(S)


def sim3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    q = quat_mul(sim3_q(A), sim3_q(B))
    sa = A[..., 7:8]
    t = sa * quat_rotate(sim3_q(A), sim3_t(B)) + sim3_t(A)
    return torch.cat([quat_normalize(q), t, sa * B[..., 7:8]], dim=-1)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(sim3_q(S))
    si = torch.reciprocal(S[..., 7:8])
    ti = -si * quat_rotate(qi, sim3_t(S))
    return torch.cat([qi, ti, si], dim=-1)


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """SE3 = [R, t/s] from a Sim3 (reference Optimizer.cc:991-1010)."""
    return se3(sim3_q(S), sim3_t(S) / S[..., 7:8])


def _sim3_V(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Translation Jacobian V(phi, sigma) of sim3_exp (t = V rho):
    A I + B W + C W^2 with the series-safe coefficients of Strasdat's
    Sim3 exp.  The scalars are kept as [..., 1, 1] tensors (see above)."""
    sigma = sigma[..., None, None]
    s = torch.exp(sigma)
    theta = _safe_norm(phi, keepdim=True)[..., None]
    W = hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    eps = 1e-5
    th2 = torch.clamp(theta * theta, min=_EPS)
    small_sig = torch.abs(sigma) < eps
    small_th = theta < eps
    A = torch.where(small_sig, 1.0 + sigma / 2.0,
                    (s - 1.0) / torch.where(small_sig, 1.0, sigma))
    c0 = torch.cos(theta)
    s0 = torch.sin(theta)
    denom = torch.clamp(sigma * sigma + th2, min=_EPS)
    a_gen = (s * s0 * sigma + (1.0 - s * c0) * theta) / torch.clamp(
        theta * denom, min=_EPS)
    b_gen = (A - ((s * c0 - 1.0) * sigma + s * s0 * theta) / denom) / th2
    a_sig0 = (1.0 - c0) / th2
    b_sig0 = (theta - s0) / torch.clamp(th2 * theta, min=_EPS)
    B = torch.where(small_sig, a_sig0, torch.where(small_th, 0.5 * A, a_gen))
    C = torch.where(small_sig, b_sig0, torch.where(small_th, A / 6.0, b_gen))
    return A * eye + B * W + C * W2


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [..., 7] = [rho, phi, sigma] -> Sim3 (s = exp(sigma),
    t = V rho)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    V = _sim3_V(phi, xi[..., 6])
    t = torch.einsum('...ij,...j->...i', V, rho)
    return torch.cat([so3_exp(phi), t, torch.exp(xi[..., 6:7])], dim=-1)


def sim3_retract(S: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """exp(xi) * S (left-multiplied update, as VertexSim3Expmap)."""
    return sim3_compose(sim3_exp(xi), S)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_exp: Sim3 -> tangent [..., 7]."""
    phi = so3_log(sim3_q(S))
    sigma = torch.log(torch.clamp(S[..., 7:8], min=_EPS))
    rho = _solve3(_sim3_V(phi, sigma[..., 0]), sim3_t(S))
    return torch.cat([rho, phi, sigma], dim=-1)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for [..., 3, 3] A by Cramer's rule.  (torch.linalg.
    solve gives wrong forward-mode derivatives under torch.func.vmap.)"""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    det = torch.sum(c0 * _cross(c1, c2), -1, keepdim=True)
    return torch.cat([torch.sum(b * _cross(c1, c2), -1, keepdim=True),
                      torch.sum(c0 * _cross(b, c2), -1, keepdim=True),
                      torch.sum(c0 * _cross(c1, b), -1, keepdim=True)],
                     -1) / det
