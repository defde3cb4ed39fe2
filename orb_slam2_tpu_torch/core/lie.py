"""SO3 / SE3 quaternion ops on batched tensors (port of
orb_slam2_tpu/core/lie.py, the subset the monocular path uses).

Representations match the reference package:
* rotation: unit quaternion ``q = [w, x, y, z]``           ``[..., 4]``
* SE3:      ``T = [qw, qx, qy, qz, tx, ty, tz]`` (Tcw)     ``[..., 7]``
Tangent vectors are ``[rho(3), phi(3)]`` (g2o ordering).
"""

from __future__ import annotations

import torch

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
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


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
    T[..., 0] = 1.0
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
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO3 left Jacobian J_l(phi), [..., 3, 3]."""
    theta = _safe_norm(phi)
    th2 = theta * theta
    W = hat(phi)
    W2 = W @ W
    small = theta < 1e-5
    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(th2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(th2 * theta, min=_EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [..., 6] = [rho, phi] -> SE3 (t = J_l(phi) rho)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    J = _so3_left_jacobian(phi)
    t = torch.einsum('...ij,...j->...i', J, rho)
    return se3(q, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(se3_q(T))
    J = _so3_left_jacobian(phi)
    rho = torch.linalg.solve_ex(J, se3_t(T)[..., None])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplied exp-map update exp(xi) * T (g2o VertexSE3Expmap)."""
    return se3_compose(se3_exp(xi), T)
