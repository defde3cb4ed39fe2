"""Batched two-view DLT triangulation (port of
orb_slam2_tpu/solvers/triangulate.py): closed-form 3x3 normal equations
(adjugate inverse) polished by two inverse-iteration steps on A^T A."""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.core import camera, lie


def triangulate_dlt(T1: torch.Tensor, T2: torch.Tensor,
                    xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] from normalized coords xn1, xn2 [..., 2] seen by
    world-to-camera poses T1, T2 (broadcastable to [..., 7])."""
    P1 = lie.se3_matrix(T1)[..., :3, :]
    P2 = lie.se3_matrix(T2)[..., :3, :]
    r1 = xn1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :]
    r2 = xn1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :]
    r3 = xn2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :]
    r4 = xn2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :]
    A = torch.cat(torch.broadcast_tensors(r1, r2, r3, r4), dim=-2)  # [..., 4, 4]
    B = A[..., :, :3]
    d = A[..., :, 3]
    G = torch.einsum('...ij,...ik->...jk', B, B)
    b = -torch.einsum('...ij,...i->...j', B, d)
    a11, a12, a13 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    a22, a23, a33 = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                                torch.full_like(det, 1e-20))
    x = (c11 * b[..., 0] + c12 * b[..., 1] + c13 * b[..., 2]) * inv_det
    y = (c12 * b[..., 0] + c22 * b[..., 1] + c23 * b[..., 2]) * inv_det
    z = (c13 * b[..., 0] + c23 * b[..., 1] + c33 * b[..., 2]) * inv_det
    X = torch.stack([x, y, z], dim=-1)

    AtA = torch.einsum('...ij,...ik->...jk', A, A)
    v = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    for _ in range(2):
        v = _adj4_apply(AtA, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-12)
    w = v[..., 3]
    ok = torch.abs(w) > 1e-9
    Xp = v[..., :3] / torch.where(ok, w, torch.ones_like(w))[..., None]
    return torch.where(ok[..., None], Xp, X)


def _adj4_apply(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """adj(A) @ v for batched 4x4 A (2x2-minor expansion)."""
    a = A
    s0 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    s1 = a[..., 0, 0] * a[..., 1, 2] - a[..., 1, 0] * a[..., 0, 2]
    s2 = a[..., 0, 0] * a[..., 1, 3] - a[..., 1, 0] * a[..., 0, 3]
    s3 = a[..., 0, 1] * a[..., 1, 2] - a[..., 1, 1] * a[..., 0, 2]
    s4 = a[..., 0, 1] * a[..., 1, 3] - a[..., 1, 1] * a[..., 0, 3]
    s5 = a[..., 0, 2] * a[..., 1, 3] - a[..., 1, 2] * a[..., 0, 3]
    c5 = a[..., 2, 2] * a[..., 3, 3] - a[..., 3, 2] * a[..., 2, 3]
    c4 = a[..., 2, 1] * a[..., 3, 3] - a[..., 3, 1] * a[..., 2, 3]
    c3 = a[..., 2, 1] * a[..., 3, 2] - a[..., 3, 1] * a[..., 2, 2]
    c2 = a[..., 2, 0] * a[..., 3, 3] - a[..., 3, 0] * a[..., 2, 3]
    c1 = a[..., 2, 0] * a[..., 3, 2] - a[..., 3, 0] * a[..., 2, 2]
    c0 = a[..., 2, 0] * a[..., 3, 1] - a[..., 3, 0] * a[..., 2, 1]
    i00 = a[..., 1, 1] * c5 - a[..., 1, 2] * c4 + a[..., 1, 3] * c3
    i01 = -a[..., 0, 1] * c5 + a[..., 0, 2] * c4 - a[..., 0, 3] * c3
    i02 = a[..., 3, 1] * s5 - a[..., 3, 2] * s4 + a[..., 3, 3] * s3
    i03 = -a[..., 2, 1] * s5 + a[..., 2, 2] * s4 - a[..., 2, 3] * s3
    i10 = -a[..., 1, 0] * c5 + a[..., 1, 2] * c2 - a[..., 1, 3] * c1
    i11 = a[..., 0, 0] * c5 - a[..., 0, 2] * c2 + a[..., 0, 3] * c1
    i12 = -a[..., 3, 0] * s5 + a[..., 3, 2] * s2 - a[..., 3, 3] * s1
    i13 = a[..., 2, 0] * s5 - a[..., 2, 2] * s2 + a[..., 2, 3] * s1
    i20 = a[..., 1, 0] * c4 - a[..., 1, 1] * c2 + a[..., 1, 3] * c0
    i21 = -a[..., 0, 0] * c4 + a[..., 0, 1] * c2 - a[..., 0, 3] * c0
    i22 = a[..., 3, 0] * s4 - a[..., 3, 1] * s2 + a[..., 3, 3] * s0
    i23 = -a[..., 2, 0] * s4 + a[..., 2, 1] * s2 - a[..., 2, 3] * s0
    i30 = -a[..., 1, 0] * c3 + a[..., 1, 1] * c1 - a[..., 1, 2] * c0
    i31 = a[..., 0, 0] * c3 - a[..., 0, 1] * c1 + a[..., 0, 2] * c0
    i32 = -a[..., 3, 0] * s3 + a[..., 3, 1] * s1 - a[..., 3, 2] * s0
    i33 = a[..., 2, 0] * s3 - a[..., 2, 1] * s1 + a[..., 2, 2] * s0
    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack([
        i00 * v0 + i01 * v1 + i02 * v2 + i03 * v3,
        i10 * v0 + i11 * v1 + i12 * v2 + i13 * v3,
        i20 * v0 + i21 * v1 + i22 * v2 + i23 * v3,
        i30 * v0 + i31 * v1 + i32 * v2 + i33 * v3], dim=-1)


def reprojection_error(T, K, pw, uv):
    """Squared pixel reprojection error [...] of world points into a view."""
    pr = camera.project(K, lie.se3_apply(T, pw))
    return torch.sum((pr - uv) ** 2, dim=-1)


def depth_in(T, pw):
    return lie.se3_apply(T, pw)[..., 2]


def parallax_cos(c1, c2, pw):
    """cos of the ray angle at pw between camera centres c1 and c2."""
    d1 = pw - c1
    d2 = pw - c2
    n1 = torch.linalg.vector_norm(d1, dim=-1)
    n2 = torch.linalg.vector_norm(d2, dim=-1)
    return torch.sum(d1 * d2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
