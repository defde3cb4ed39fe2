"""Synthetic sequence generator with exact ground truth (a numpy-only copy
of orb_slam2_tpu/io/synthetic.py, mono trajectories).

The JAX package renders with OpenCV (cubic resize, Gaussian blur, bilinear
remap with wrap-around).  This copy implements those three operations in
numpy with OpenCV's definitions — cubic coefficients with A = -0.75 and
replicated edges, a 9-tap sigma-1 kernel with reflect-101 edges, texture
coordinates quantized to 1/32 px — so it runs where OpenCV is not
installed and renders the same scenes up to interpolation round-off.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orb_slam2_tpu_torch.config import CameraConfig


@dataclasses.dataclass
class SyntheticSequence:
    images: np.ndarray     # [F, H, W] float32 0..255
    depths: np.ndarray     # [F, H, W] float32 (0 = invalid)
    poses_twc: np.ndarray  # [F, 7] ground truth camera-to-world
    timestamps: np.ndarray  # [F]
    points: np.ndarray     # [P, 3] landmark ground truth


def _quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])


def _quat_rot(q, v):
    w, x, y, z = q
    qv = np.array([x, y, z])
    t = 2 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def xyz_trajectory(n_frames: int, amp=0.35, rot_amp=0.04) -> np.ndarray:
    """fr1/xyz-style trajectory: smooth translation along all three axes
    with mild rotation.  Returns Twc [F, 7] (quat wxyz + t)."""
    ts = np.linspace(0, 4 * np.pi, n_frames)
    poses = np.zeros((n_frames, 7))
    for i, s in enumerate(ts):
        t = np.array([amp * np.sin(s), amp * 0.6 * np.sin(0.7 * s + 1.0),
                      amp * 0.4 * np.sin(0.5 * s)])
        qx = _quat_from_axis_angle([0, 1, 0], rot_amp * np.sin(0.8 * s))
        qy = _quat_from_axis_angle([1, 0, 0],
                                   rot_amp * 0.7 * np.sin(0.6 * s + 0.5))
        q = _quat_mul(qx, qy)
        poses[i, :4] = q / np.linalg.norm(q)
        poses[i, 4:] = t
    return poses


def loop_trajectory(n_frames: int, radius=1.2,
                    revolutions: float = 1.0) -> np.ndarray:
    """Closed circular path with a full yaw that follows the tangent."""
    poses = np.zeros((n_frames, 7))
    for i in range(n_frames):
        s = 2 * np.pi * revolutions * i / n_frames
        t = np.array([radius * np.sin(s), 0.0, radius * (1 - np.cos(s))])
        q = _quat_from_axis_angle([0, 1, 0], s)
        poses[i, :4] = q / np.linalg.norm(q)
        poses[i, 4:] = t
    return poses


# ---------------------------------------------------------------------------
# the three OpenCV operations the renderer needs
# ---------------------------------------------------------------------------

def _cubic_axis(src: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """cv2.resize INTER_CUBIC along one axis (A = -0.75, replicated edge)."""
    n_in = src.shape[axis]
    fx = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    out = 0
    for k, c in enumerate((c0, c1, c2, c3)):
        idx = np.clip(sx - 1 + k, 0, n_in - 1)
        taken = np.take(src, idx, axis=axis)
        shape = [1] * src.ndim
        shape[axis] = n_out
        out = out + taken * c.reshape(shape)
    return out.astype(np.float32)


def _resize_cubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    return _cubic_axis(_cubic_axis(img, w, 1), h, 0)


def _gaussian_blur_sigma1(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), 1.0) on float32: 9 taps, reflect-101."""
    x = np.arange(-4, 5, dtype=np.float64)
    k = np.exp(-0.5 * x * x)
    k = (k / k.sum()).astype(np.float32)
    p = np.pad(img, 4, mode="reflect")
    H, W = img.shape
    rows = sum(p[:, i:i + W] * k[i] for i in range(9))
    return sum(rows[i:i + H, :] * k[i] for i in range(9)).astype(np.float32)


def _remap_wrap(tex: np.ndarray, map_x: np.ndarray,
                map_y: np.ndarray) -> np.ndarray:
    """cv2.remap INTER_LINEAR, BORDER_WRAP: coordinates rounded to 1/32 px,
    each of the four taps wrapped independently."""
    th, tw = tex.shape
    X = np.rint(np.clip(map_x, -1e7, 1e7) * 32.0).astype(np.int64)
    Y = np.rint(np.clip(map_y, -1e7, 1e7) * 32.0).astype(np.int64)
    ix, iy = X >> 5, Y >> 5
    ax = (X & 31).astype(np.float32) / 32.0
    ay = (Y & 31).astype(np.float32) / 32.0
    x0, x1 = ix % tw, (ix + 1) % tw
    y0, y1 = iy % th, (iy + 1) % th
    return ((tex[y0, x0] * (1 - ax) + tex[y0, x1] * ax) * (1 - ay) +
            (tex[y1, x0] * (1 - ax) + tex[y1, x1] * ax) * ay
            ).astype(np.float32)


def _plane_texture(rng, th: int, tw: int) -> np.ndarray:
    """Smooth ORB-friendly texture: low-frequency blobs + mid-frequency
    detail, mildly blurred."""
    g = rng.rand(th // 12 + 2, tw // 12 + 2).astype(np.float32)
    tex = _resize_cubic(g, tw, th) * 150
    d = rng.rand(th // 4 + 2, tw // 4 + 2).astype(np.float32)
    tex += _resize_cubic(d, tw, th) * 60
    tex = _gaussian_blur_sigma1(tex)
    t0, t1 = tex.min(), tex.max()
    return (tex - t0) / max(t1 - t0, 1e-6) * 195.0 + 30.0


def generate(cam: CameraConfig, n_frames: int = 120, n_points: int = 600,
             trajectory: str = "xyz", seed: int = 0,
             depth_range=(2.0, 8.0), noise_sigma: float = 1.0,
             loop_revolutions: float = 1.0) -> SyntheticSequence:
    """Render a textured room (5 planes, ray-cast with a z-buffer) along a
    smooth camera trajectory, with exact ground-truth poses."""
    rng = np.random.RandomState(seed)
    H, W = cam.height, cam.width
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    if trajectory == "xyz":
        twc = xyz_trajectory(n_frames)
    elif trajectory == "loop":
        twc = loop_trajectory(n_frames, revolutions=loop_revolutions)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")

    zf, zn = depth_range[1], depth_range[0]
    ex = zn * (W / 2) / fx * 1.6
    ey = zn * (H / 2) / fy * 1.6
    planes = [
        (np.array([0, 0, zf]), np.array([0, 0, -1.0]),
         np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([0, ey, 0]), np.array([0, -1.0, 0]),
         np.array([1.0, 0, 0]), np.array([0, 0, 1.0])),
        (np.array([0, -ey, 0]), np.array([0, 1.0, 0]),
         np.array([1.0, 0, 0]), np.array([0, 0, 1.0])),
        (np.array([-ex, 0, 0]), np.array([1.0, 0, 0]),
         np.array([0, 0, 1.0]), np.array([0, 1.0, 0])),
        (np.array([ex, 0, 0]), np.array([-1.0, 0, 0]),
         np.array([0, 0, 1.0]), np.array([0, 1.0, 0])),
    ]
    ppm = max(fx, fy) / ((zn + zf) * 0.5) * 1.2
    texes = []
    for _ in planes:
        span = 2.0 * max(ex, ey, zf)
        tw = int(np.clip(span * ppm, 256, 4096))
        texes.append((_plane_texture(rng, tw, tw), span))

    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)

    def _R_of(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])

    images = np.zeros((n_frames, H, W), np.float32)
    depths = np.zeros((n_frames, H, W), np.float32)
    for f in range(n_frames):
        q, t = twc[f, :4], twc[f, 4:]
        dirs = rays @ _R_of(q).T
        img = np.zeros((H, W), np.float32)
        zbuf = np.full((H, W), np.inf, np.float32)
        for (p0, n, ua, va), (tex, span) in zip(planes, texes):
            denom = dirs @ n
            lam = ((p0 - t) @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            hit = lam > 0.05
            Xw = t[None, None, :] + lam[..., None] * dirs
            tu = (Xw - p0) @ ua
            tv = (Xw - p0) @ va
            th_, tw_ = tex.shape
            map_x = ((tu / span + 0.5) * (tw_ - 1)).astype(np.float32)
            map_y = ((tv / span + 0.5) * (th_ - 1)).astype(np.float32)
            col = _remap_wrap(tex, map_x, map_y)
            closer = hit & (lam < zbuf)
            img = np.where(closer, col, img)
            zbuf = np.where(closer, lam, zbuf)
        if noise_sigma > 0:
            img = img + rng.randn(H, W).astype(np.float32) * noise_sigma
        images[f] = np.clip(img, 0, 255)
        depths[f] = np.where(np.isfinite(zbuf), zbuf, 0.0)

    u = rng.uniform(5, W - 5, n_points).astype(np.float32)
    v = rng.uniform(5, H - 5, n_points).astype(np.float32)
    z0 = depths[0][v.astype(int), u.astype(int)]
    pc0 = np.stack([(u - cx) / fx * z0, (v - cy) / fy * z0, z0], -1)
    q0, t0 = twc[0, :4], twc[0, 4:]
    pts = np.stack([_quat_rot(q0, p) for p in pc0]) + t0
    timestamps = np.arange(n_frames) / cam.fps
    return SyntheticSequence(images=images, depths=depths, poses_twc=twc,
                             timestamps=timestamps, points=pts)
