"""The benchmark's inputs, rendered on the card from the seed.

The scene is `scene.py`'s (a copy of the port's numpy generator): a room
of five textured planes, ray-cast with a z-buffer along a camera
trajectory, with exact ground truth.  The numpy copy renders a frame in
~0.3 s at 640x480 (~0.7 s at KITTI's 1241x376), too slow for the
thousands of frames a run plays, so the per-frame ray cast, the texture
lookup (bilinear, coordinates rounded to 1/32 px, wrapped) and the sensor
noise run here in torch on the card, and the textures' cubic resize and
blur too.  The random draws of the textures are numpy's, in `scene.py`'s
order; the noise is drawn on the card.  With no noise the frames equal the
numpy copy's up to round-off (`tests/test_portbench_render.py`).

What differs from the numpy copy, by design:
- a camera with a lens (k1 k2 p1 p2 k3) casts each pixel's ray through
  the lens: the ray of pixel (u, v) is its undistorted normalised point,
  so the undistortion runs in the program's step as on a real fr1 image;
- images are quantised to 8 bits and depth to 16 bits at the camera's
  depth-map factor (0 = none), then converted as the port's TUM reader
  converts a PNG (`d.astype(float32) / factor`);
- the trajectories take a phase (0 in every cell), and `drive` is a
  corridor drive with a gentle, bounded weave instead of `forward`'s
  constant yaw (which leaves the corridor after ~200 frames);
- `loop`, a lap of a ring road round a city block and back past its
  start, has a room of its own (`loop_room`): a box, and the block as four
  walls that end at their edges (a plane's optional extent), so that the
  block hides the start from the far side of the lap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from portbench import scene

DEPTH_RANGE = (2.0, 8.0)
NOISE_SIGMA = 1.0
RENDER_BATCH = 8


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    fps: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0
    depth_map_factor: float = 5000.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0

    @property
    def has_lens(self) -> bool:
        return any((self.k1, self.k2, self.p1, self.p2, self.k3))


def rng_for(seed: int, *stream: int) -> np.random.RandomState:
    """numpy's RandomState for (seed, stream): any whole seed, also one
    above 32 bits."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64)] + list(stream))
    return np.random.RandomState(ss.generate_state(4))


def torch_seed(seed: int, *stream: int) -> int:
    ss = np.random.SeedSequence([int(seed) % (1 << 64)] + list(stream))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------------------
# trajectories (Twc [F, 7], quaternion wxyz + t)
# ---------------------------------------------------------------------------

def xyz_trajectory(n_frames: int, phase: float = 0.0, amp=0.35,
                   rot_amp=0.04, turns: float = 2.0) -> np.ndarray:
    """`scene.xyz_trajectory` (fr1/xyz-style: translation along the three
    axes, mild rotation) over `turns` periods of its x motion, started at
    `phase`; the defaults are the copy's."""
    ts = np.linspace(0, 2 * np.pi * turns, n_frames) + phase
    poses = np.zeros((n_frames, 7))
    for i, s in enumerate(ts):
        t = np.array([amp * np.sin(s), amp * 0.6 * np.sin(0.7 * s + 1.0),
                      amp * 0.4 * np.sin(0.5 * s)])
        qx = scene._quat_from_axis_angle([0, 1, 0], rot_amp * np.sin(0.8 * s))
        qy = scene._quat_from_axis_angle([1, 0, 0],
                                         rot_amp * 0.7 * np.sin(0.6 * s + 0.5))
        q = scene._quat_mul(qx, qy)
        poses[i, :4] = q / np.linalg.norm(q)
        poses[i, 4:] = t
    return poses


def drive_trajectory(n_frames: int, phase: float = 0.0, speed=0.08,
                     yaw_amp=0.1, period=550.0) -> np.ndarray:
    """A drive down the corridor: `speed` m a frame along the camera's
    optical axis, the yaw weaving as yaw_amp * sin(2 pi f / period +
    phase), so the car never turns back and stays within ~1.5 m of the
    corridor's axis."""
    poses = np.zeros((n_frames, 7))
    pos = np.zeros(3)
    for i in range(n_frames):
        yaw = yaw_amp * np.sin(2 * np.pi * i / period + phase)
        q = scene._quat_from_axis_angle([0, 1, 0], yaw)
        poses[i, :4] = q
        poses[i, 4:] = pos
        pos = pos + speed * scene._quat_rot(q, np.array([0, 0, 1.0]))
    return poses


def loop_lap(speed, block, ring, corner, overrun=0) -> Tuple[float, int]:
    """(metres, frames) of one lap of the ring road's centreline: a square
    `ring` / 2 from the block's walls, its corners rounded to quarter
    circles of radius `corner`; the frames a lap are L / `speed` rounded,
    so that a whole number of frames makes the lap (`overrun` is taken so
    that a traffic's `motion` passes whole)."""
    a = block / 2 + ring / 2
    if not 0 < corner <= a:
        raise ValueError(f"a corner radius of {corner} m does not fit a "
                         f"route {a} m from the block's centre")
    lap = 8 * (a - corner) + 2 * np.pi * corner
    return lap, int(round(lap / speed))


def loop_trajectory(n_frames: int, phase: float = 0.0, *, speed, block,
                    ring, corner, overrun) -> np.ndarray:
    """A car's drive round a square city block `block` m a side, in the
    middle of a ring road `ring` m wide with the block on its left,
    starting at the middle of a straight and heading along it: one
    lap, back to the start pose, then `overrun` frames past it.  The
    straights are joined by quarter circles of radius `corner`; the step
    is the lap over its whole frames (`loop_lap`, ~`speed` m a frame);
    `phase` moves the start by phase / 2 pi of a lap.  `n_frames` must be
    the lap's frames plus `overrun`; every key is the traffic's to set."""
    lap, n_lap = loop_lap(speed, block, ring, corner)
    if n_frames != n_lap + overrun:
        raise ValueError(f"a lap of {n_lap} frames and an overrun of "
                         f"{overrun} make {n_lap + overrun} frames, not "
                         f"{n_frames}")
    a = block / 2 + ring / 2
    h, c = a - corner, corner
    quarter = lap / 4
    s = np.mod(phase / (2 * np.pi) * lap
               + np.arange(n_frames) * (lap / n_lap), lap)
    k = np.minimum(np.floor(s / quarter), 3)
    u = s - k * quarter
    # one quarter, from the middle of the x = +a straight to the middle of
    # the z = +a one: straight, arc about (h, h), straight
    phi = np.clip((u - h) / c, 0, np.pi / 2)
    on_arc = (u >= h) & (u < h + c * np.pi / 2)
    after = u >= h + c * np.pi / 2
    x = np.where(after, h - (u - h - c * np.pi / 2),
                 np.where(on_arc, h + c * np.cos(phi), a))
    z = np.where(after, a, np.where(on_arc, h + c * np.sin(phi), u))
    yaw = np.where(after, -np.pi / 2, np.where(on_arc, -phi, 0.0))
    # the quarter turned k times by -90 degrees about y
    th = -k * np.pi / 2
    xr = x * np.cos(th) + z * np.sin(th)
    zr = -x * np.sin(th) + z * np.cos(th)
    yaw = yaw + th
    yaw = yaw - 2 * np.pi * np.round(yaw / (2 * np.pi))
    poses = np.zeros((n_frames, 7))
    poses[:, 0] = np.cos(yaw / 2)
    poses[:, 2] = np.sin(yaw / 2)
    poses[:, 4] = xr
    poses[:, 6] = zr
    return poses


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """A trajectory: its poses (n_frames, phase, **motion) -> Twc [n, 7],
    its room (cam, n_frames, depth_range, motion) -> Room and, for one
    that comes back to its start, its lap (motion) -> frames: frame
    i + lap is at frame i's pose."""
    poses: Callable
    room: Callable
    lap: Optional[Callable] = None


TRAJECTORIES = {
    "xyz": Trajectory(xyz_trajectory, lambda cam, n, depth_range, m:
                      make_room(cam, n, False, depth_range)),
    "drive": Trajectory(drive_trajectory, lambda cam, n, depth_range, m:
                        make_room(cam, n, True, depth_range)),
    "loop": Trajectory(loop_trajectory, lambda cam, n, depth_range, m:
                       loop_room(cam, m["block"], m["ring"]),
                       lambda m: loop_lap(**m)[1]),
}


def lap_frames(trajectory: str, motion: Optional[dict]) -> Optional[int]:
    """The frames of a lap of a trajectory that comes back to its start
    (`Trajectory.lap`); None for one that never does."""
    lap = TRAJECTORIES[trajectory].lap
    return None if lap is None else lap(motion or {})


# ---------------------------------------------------------------------------
# the room (scene.generate's, as data the plain reference also reads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Room:
    planes: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    spans: List[float]
    tex_sizes: List[int]
    # a plane's (half_u, half_v) about its point, None: infinite
    extents: Optional[List[Optional[Tuple[float, float]]]] = None


def make_room(cam: Camera, n_frames: int, corridor: bool,
              depth_range=DEPTH_RANGE) -> Room:
    """The five planes (point, normal, u axis, v axis) and texture sizes of
    `scene.generate` (its `forward` corridor when `corridor`)."""
    zn, zf = depth_range
    ex = zn * (cam.width / 2) / cam.fx * 1.6
    ey = zn * (cam.height / 2) / cam.fy * 1.6
    if corridor:
        zf = 0.1 * n_frames + depth_range[1] * 2
        ex *= 3.0
        ey *= 3.0
    a = np.array
    planes = [
        (a([0, 0, zf]), a([0, 0, -1.0]), a([1.0, 0, 0]), a([0, 1.0, 0])),
        (a([0, ey, 0]), a([0, -1.0, 0]), a([1.0, 0, 0]), a([0, 0, 1.0])),
        (a([0, -ey, 0]), a([0, 1.0, 0]), a([1.0, 0, 0]), a([0, 0, 1.0])),
        (a([-ex, 0, 0]), a([1.0, 0, 0]), a([0, 0, 1.0]), a([0, 1.0, 0])),
        (a([ex, 0, 0]), a([-1.0, 0, 0]), a([0, 0, 1.0]), a([0, 1.0, 0])),
    ]
    ppm = max(cam.fx, cam.fy) / ((zn + zf) * 0.5) * 1.2
    span = 2.0 * max(ex, ey, zf)
    tw = int(np.clip(span * ppm, 256, 4096))
    return Room(planes=planes, spans=[span] * 5, tex_sizes=[tw] * 5)


def loop_room(cam: Camera, block: float, ring: float) -> Room:
    """The ring road's room: an outer box (four walls `ring` m beyond the
    block's, a floor and a ceiling `ring` / 2 m below and above the
    camera), and the block, four walls `block` m long that end at their
    edges.  Each plane has a texture of its own, drawn in that order, whose
    span is the plane's whole width, so no wall repeats its texture
    anywhere (no false revisit from the wrap); the texture's resolution is
    `make_room`'s rule, from the nearest wall (beside the road) and the
    farthest (across the box)."""
    b, o, e = block / 2, block / 2 + ring, ring / 2
    a = np.array
    X, Y, Z = a([1.0, 0, 0]), a([0, 1.0, 0]), a([0, 0, 1.0])
    walls = [(x * X, -np.sign(x) * X, Z, Y) for x in (o, -o)] + \
            [(z * Z, -np.sign(z) * Z, X, Y) for z in (o, -o)]
    blocks = [(x * X, np.sign(x) * X, Z, Y) for x in (b, -b)] + \
             [(z * Z, np.sign(z) * Z, X, Y) for z in (b, -b)]
    floors = [(a([0, e, 0]), -Y, X, Z), (a([0, -e, 0]), Y, X, Z)]
    spans = [2 * o] * 4 + [2 * b] * 4 + [2 * o] * 2
    zn, zf = e, 2 * o
    ppm = max(cam.fx, cam.fy) / ((zn + zf) * 0.5) * 1.2
    return Room(planes=walls + blocks + floors, spans=spans,
                tex_sizes=[int(np.clip(sp * ppm, 256, 4096)) for sp in spans],
                extents=[None] * 4 + [(b, e)] * 4 + [None] * 2)


# ---------------------------------------------------------------------------
# textures: scene._plane_texture's draws, resized and blurred on the card
# ---------------------------------------------------------------------------

def _cubic_axis(src: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """scene._cubic_axis (cv2 INTER_CUBIC, A = -0.75, replicated edge)."""
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
    shape = [1] * src.dim()
    shape[axis] = n_out
    for k, c in enumerate((c0, c1, c2, c3)):
        idx = torch.as_tensor(np.clip(sx - 1 + k, 0, n_in - 1),
                              device=src.device)
        taken = torch.index_select(src, axis, idx)
        out = out + taken * torch.as_tensor(c, device=src.device
                                            ).reshape(shape)
    return out


def _blur_sigma1(img: torch.Tensor) -> torch.Tensor:
    """scene._gaussian_blur_sigma1: 9 taps, reflect-101 edges."""
    x = np.arange(-4, 5, dtype=np.float64)
    k = np.exp(-0.5 * x * x)
    k = (k / k.sum()).astype(np.float32)
    H, W = img.shape
    p = torch.nn.functional.pad(img[None, None], (4, 4, 4, 4),
                                mode="reflect")[0, 0]
    rows = sum(p[:, i:i + W] * float(k[i]) for i in range(9))
    return sum(rows[i:i + H, :] * float(k[i]) for i in range(9))


def make_textures(rng: np.random.RandomState, room: Room,
                  device) -> List[torch.Tensor]:
    """One texture a plane, drawn in scene.generate's order."""
    out = []
    for tw in room.tex_sizes:
        th = tw
        g = torch.as_tensor(rng.rand(th // 12 + 2, tw // 12 + 2).astype(
            np.float32), device=device)
        tex = _cubic_axis(_cubic_axis(g, tw, 1), th, 0) * 150
        d = torch.as_tensor(rng.rand(th // 4 + 2, tw // 4 + 2).astype(
            np.float32), device=device)
        tex = tex + _cubic_axis(_cubic_axis(d, tw, 1), th, 0) * 60
        tex = _blur_sigma1(tex)
        t0, t1 = tex.min(), tex.max()
        out.append((tex - t0) / torch.clamp(t1 - t0, min=1e-6) * 195.0
                   + 30.0)
    return out


# ---------------------------------------------------------------------------
# the ray cast
# ---------------------------------------------------------------------------

def undistort_normalised(cam: Camera, u: np.ndarray, v: np.ndarray,
                         iters: int = 40) -> Tuple[np.ndarray, np.ndarray]:
    """The normalised point (x, y) that the lens maps to pixel (u, v):
    fixed-point iteration of the Brown-Conrady model in float64."""
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 ** 3
        dx = 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
        dy = cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return x, y


def distort_pixels(cam: Camera, x: np.ndarray, y: np.ndarray):
    """Pixel coordinates of normalised points (x, y) through the lens."""
    r2 = x * x + y * y
    rad = 1 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 ** 3
    xd = x * rad + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * rad + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return xd * cam.fx + cam.cx, yd * cam.fy + cam.cy


def pixel_rays(cam: Camera, device) -> torch.Tensor:
    """[H, W, 3] float64 camera rays with unit z."""
    uu, vv = np.meshgrid(np.arange(cam.width, dtype=np.float32),
                         np.arange(cam.height, dtype=np.float32))
    if cam.has_lens:
        x, y = undistort_normalised(cam, uu.astype(np.float64),
                                    vv.astype(np.float64))
    else:
        x, y = (uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy
    rays = np.stack([x, y, np.ones_like(x)], -1).astype(np.float64)
    return torch.as_tensor(rays, device=device)


def _rotations(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _remap_wrap(tex: torch.Tensor, map_x: torch.Tensor,
                map_y: torch.Tensor) -> torch.Tensor:
    """scene._remap with wrap: coordinates rounded to 1/32 px."""
    th, tw = tex.shape
    X = torch.round(torch.clamp(map_x, -1e7, 1e7) * 32.0).to(torch.int64)
    Y = torch.round(torch.clamp(map_y, -1e7, 1e7) * 32.0).to(torch.int64)
    ix, iy = X >> 5, Y >> 5
    ax = (X & 31).to(torch.float32) / 32.0
    ay = (Y & 31).to(torch.float32) / 32.0
    x0, x1 = ix % tw, (ix + 1) % tw
    y0, y1 = iy % th, (iy + 1) % th
    flat = tex.reshape(-1)
    at = lambda yy, xx: flat[yy * tw + xx]
    return ((at(y0, x0) * (1 - ax) + at(y0, x1) * ax) * (1 - ay) +
            (at(y1, x0) * (1 - ax) + at(y1, x1) * ax) * ay)


def cast(room: Room, texes, rays: torch.Tensor, twc: np.ndarray):
    """Float images and depth [b, H, W] (depth 0 where nothing is hit) of
    the poses twc [b, 7], before noise."""
    dev = rays.device
    R = torch.as_tensor(_rotations(twc[:, :4]), device=dev)       # [b,3,3]
    t = torch.as_tensor(twc[:, 4:], device=dev)                   # [b, 3]
    dirs = torch.einsum("hwk,bjk->bhwj", rays, R)                 # [b,H,W,3]
    b, H, W = dirs.shape[:3]
    img = torch.zeros((b, H, W), dtype=torch.float32, device=dev)
    zbuf = torch.full((b, H, W), float("inf"), dtype=torch.float64,
                      device=dev)
    extents = room.extents or [None] * len(room.planes)
    for (p0, n, ua, va), tex, span, ext in zip(room.planes, texes,
                                               room.spans, extents):
        p0_, n_, ua_, va_ = (torch.as_tensor(v, device=dev)
                             for v in (p0, n, ua, va))
        denom = dirs @ n_
        lam = ((p0_[None] - t) @ n_)[:, None, None] / torch.where(
            denom.abs() > 1e-9, denom, torch.full_like(denom, 1e-9))
        hit = lam > 0.05
        Xw = t[:, None, None, :] + lam[..., None] * dirs
        tu = (Xw - p0_) @ ua_
        tv = (Xw - p0_) @ va_
        if ext is not None:
            hit = hit & (tu.abs() <= ext[0]) & (tv.abs() <= ext[1])
        th_, tw_ = tex.shape
        map_x = ((tu / span + 0.5) * (tw_ - 1)).to(torch.float32)
        map_y = ((tv / span + 0.5) * (th_ - 1)).to(torch.float32)
        col = _remap_wrap(tex, map_x, map_y)
        closer = hit & (lam < zbuf)
        img = torch.where(closer, col, img)
        zbuf = torch.where(closer, lam, zbuf)
    depth = torch.where(torch.isfinite(zbuf), zbuf,
                        torch.zeros_like(zbuf)).to(torch.float32)
    return img, depth


@dataclasses.dataclass
class Sequence:
    images: torch.Tensor            # [F, H, W] uint8
    right: Optional[torch.Tensor]   # [F, H, W] uint8 (stereo)
    depth: Optional[torch.Tensor]   # [F, H, W] float32 metres (RGB-D)
    twc: np.ndarray                 # [F, 7] ground truth Twc (left camera)
    room: Room
    fps: float


def render_sequence(cam: Camera, trajectory: str, n_frames: int, seed: int,
                    stereo: bool, with_depth: bool, device,
                    out_device=None, noise_sigma: float = NOISE_SIGMA,
                    phase: float = 0.0,
                    depth_range=DEPTH_RANGE,
                    motion: Optional[dict] = None,
                    texture_seed: Optional[int] = None) -> Sequence:
    """Render one sequence: the room's textures are drawn from
    `texture_seed` (`seed` when None), the noise from `seed`; the
    trajectory starts at `phase` whatever the seed.  The cells fix their
    textures, so that the seed changes the noise and not the work (seeded
    textures, or a seeded phase, flip keyframe decisions from seed to
    seed).  Images go to `out_device`
    (the render device by default) as 8 bits; depth, when asked for, as
    16 bits at the camera's factor converted to metres.  `depth_range`
    (near, far) sizes the room as `scene.generate` does; `motion` passes
    the trajectory's amplitudes (`amp`, `rot_amp`; `speed`, `yaw_amp`;
    the ring road's `loop_trajectory` keys, which also size its room)."""
    rng = rng_for(seed if texture_seed is None else texture_seed, 0)
    traj = TRAJECTORIES[trajectory]
    twc = traj.poses(n_frames, phase, **(motion or {}))
    room = traj.room(cam, n_frames, depth_range, motion or {})
    texes = make_textures(rng, room, device)
    rays = pixel_rays(cam, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 2))
    out_device = out_device or device
    H, W = cam.height, cam.width
    eyes = [twc] + ([scene.right_poses(twc, cam.baseline)] if stereo else [])
    imgs = [torch.empty((n_frames, H, W), dtype=torch.uint8,
                        device=out_device) for _ in eyes]
    depth = torch.empty((n_frames, H, W), dtype=torch.float32,
                        device=out_device) if with_depth else None
    for f0 in range(0, n_frames, RENDER_BATCH):
        f1 = min(f0 + RENDER_BATCH, n_frames)
        for e, poses in enumerate(eyes):
            img, z = cast(room, texes, rays, poses[f0:f1])
            if noise_sigma > 0:
                img = img + torch.randn(img.shape, generator=gen,
                                        device=device) * noise_sigma
            imgs[e][f0:f1] = torch.round(torch.clamp(img, 0, 255)).to(
                torch.uint8).to(out_device)
            if e == 0 and with_depth:
                raw = torch.round(z.double() * cam.depth_map_factor)
                raw = torch.where(raw <= 65535, raw, torch.zeros_like(raw))
                depth[f0:f1] = (raw.to(torch.float32) /
                                cam.depth_map_factor).to(out_device)
    del texes, rays
    return Sequence(images=imgs[0], right=imgs[1] if stereo else None,
                    depth=depth, twc=twc, room=room, fps=cam.fps)
