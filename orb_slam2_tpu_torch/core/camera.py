"""Pinhole camera model (port of orb_slam2_tpu/core/camera.py, the subset
the monocular path uses).

Intrinsics are packed ``K = [fx, fy, cx, cy]`` and distortion
``dist = [k1, k2, p1, p2, k3]``; functions take any leading batch dims.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.config import CameraConfig


def intrinsics(cfg: CameraConfig, device=None) -> torch.Tensor:
    return torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy], dtype=torch.float32,
                        device=device)


def distortion(cfg: CameraConfig, device=None) -> torch.Tensor:
    return torch.tensor([cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3],
                        dtype=torch.float32, device=device)


def project(K: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2]."""
    z = p_cam[..., 2:3]
    xy = p_cam[..., :2] / torch.where(torch.abs(z) > 1e-9, z,
                                      torch.full_like(z, 1e-9))
    return xy * K[..., :2] + K[..., 2:4]


def distort_normalized(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(K: torch.Tensor, dist: torch.Tensor, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints by fixed-point iteration (the batched form
    of cv::undistortPoints); returns undistorted pixel coords under K."""
    xy_d = (uv - K[..., 2:4]) / K[..., :2]
    xy = xy_d
    for _ in range(iters):
        d = distort_normalized(dist, xy)
        xy = xy_d - (d - xy)
    return xy * K[..., :2] + K[..., 2:4]


def in_image(uv: torch.Tensor, bounds) -> torch.Tensor:
    """bounds = [min_x, max_x, min_y, max_y]."""
    return ((uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1]) &
            (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3]))
