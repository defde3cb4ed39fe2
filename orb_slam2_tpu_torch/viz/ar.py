"""Augmented-reality demo support: plane detection + anchored cube render
(port of orb_slam2_tpu/viz/ar.py).

The equivalent of the reference MonoAR demo
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc): `detect_plane` fits a
dominant plane to the tracked map points with 3-point RANSAC
(ViewerAR.cc:392-470: 50 iterations, points need > 5 observations, >= 50
points required; numpy with `RandomState(seed)`, so it draws what the JAX
package draws) and the cube is drawn anchored to that plane
(ViewerAR.cc:187-207), recomputed whenever the map reports a big change
(`SLAM.map_changed`).  Rendering is headless (`viz/raster.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from orb_slam2_tpu_torch.core import camera
from orb_slam2_tpu_torch.io.png import write_png
from orb_slam2_tpu_torch.map.state import point_obs_count
from orb_slam2_tpu_torch.viz.raster import Line, Scene, Text, render
from orb_slam2_tpu_torch.viz.viewer import _np


class Plane:
    """Plane through tracked map points: z=0 of `Tpw` (world -> plane)."""

    def __init__(self, normal: np.ndarray, origin: np.ndarray):
        self.n = normal / max(np.linalg.norm(normal), 1e-12)
        self.o = origin
        # plane frame: z axis = normal (ViewerAR ExpSO3 equivalent)
        up = np.array([1.0, 0, 0]) if abs(self.n[0]) < 0.9 else \
            np.array([0, 1.0, 0])
        x = np.cross(up, self.n)
        x /= max(np.linalg.norm(x), 1e-12)
        y = np.cross(self.n, x)
        self.Rwp = np.stack([x, y, self.n], axis=1)   # plane -> world


def detect_plane(mp_pos: np.ndarray, mp_valid: np.ndarray,
                 obs_count: np.ndarray, iters: int = 50,
                 min_obs: int = 5, min_points: int = 50,
                 seed: int = 0) -> Optional[Plane]:
    """RANSAC plane fit over well-observed tracked points (reference
    ViewerAR::DetectPlane, ViewerAR.cc:392-470: 3-point hypotheses ranked
    by the median point distance; None when < `min_points` qualify)."""
    pts = mp_pos[mp_valid & (obs_count > min_obs)]
    n = len(pts)
    if n < min_points:
        return None
    rng = np.random.RandomState(seed)
    best_med, best = np.inf, None
    for _ in range(iters):
        i = rng.choice(n, 3, replace=False)
        a, b, c = pts[i]
        nrm = np.cross(b - a, c - a)
        ln = np.linalg.norm(nrm)
        if ln < 1e-9:
            continue
        nrm = nrm / ln
        d = np.abs((pts - a) @ nrm)
        med = np.median(d)
        if med < best_med:
            best_med, best = med, (nrm, a)
    if best is None:
        return None
    nrm, a = best
    d = np.abs((pts - a) @ nrm)
    inl = d < max(2.5 * best_med, 1e-6)
    # least-squares refit on the inliers (the reference's final cv::SVD)
    q = pts[inl]
    o = q.mean(0)
    _, _, vt = np.linalg.svd(q - o, full_matrices=False)
    n_ref = vt[-1]
    if n_ref @ nrm < 0:
        n_ref = -n_ref
    return Plane(n_ref, o)


def cube_vertices(plane: Plane, size: float) -> np.ndarray:
    """[8, 3] world-space cube corners sitting on the plane (the reference
    draws a glutSolidCube lifted by size/2 along the plane normal,
    ViewerAR.cc:187-207)."""
    s = size / 2.0
    local = np.array([[x, y, z] for z in (0.0, size)
                      for y in (-s, s) for x in (-s, s)])
    return local @ plane.Rwp.T + plane.o


CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def ar_scene(img: np.ndarray, Tcw: np.ndarray, K4: np.ndarray,
             plane: Optional[Plane], cube_size: float = 0.08,
             status: str = "") -> Scene:
    """The primitives of `render_ar`: the cube's 12 edges projected into
    the frame (when every corner is > 0.05 in front of the camera) and the
    status text on a translucent black box."""
    img = _np(img)
    h, w = img.shape[:2]
    lines = []
    if plane is not None:
        q, t = Tcw[:4], Tcw[4:7]
        qw, qx, qy, qz = q
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]])
        verts = cube_vertices(plane, cube_size) @ R.T + t
        if np.all(verts[:, 2] > 0.05):
            fx, fy, cx, cy = K4
            uv = np.stack([fx * verts[:, 0] / verts[:, 2] + cx,
                           fy * verts[:, 1] / verts[:, 2] + cy], -1)
            lines = [Line(np.asarray(uv[[a, b]], np.float64), "lime", 1.6)
                     for a, b in CUBE_EDGES]
    texts = [Text((4.0, h - 8.0), status, "white", 9.0, box="black",
                  box_alpha=0.5)] if status else []
    return Scene(size=(w, h), dpi=100.0, axes="image", lines=lines,
                 texts=texts, image=img)


def render_ar(img: np.ndarray, Tcw: np.ndarray, K4: np.ndarray,
              plane: Optional[Plane], out_path: str,
              cube_size: float = 0.08, status: str = "") -> str:
    """Overlay the anchored cube on the camera frame and save a w x h PNG
    to out_path.  Tcw: [7] (wxyz quat + t) world->camera; K4: [fx, fy, cx,
    cy]."""
    return write_png(out_path, render(ar_scene(img, Tcw, K4, plane,
                                               cube_size, status)))


class ARSession:
    """Drive-loop helper replicating the MonoAR node: feed frames through
    SLAM, (re)detect the plane when the map changes, render the anchored
    cube (ViewerAR.cc:136-231 + MapChanged recompute 392-470)."""

    def __init__(self, slam, cube_size: float = 0.08):
        self.slam = slam
        self.plane: Optional[Plane] = None
        self.cube_size = cube_size

    def step(self, img: np.ndarray, timestamp: float,
             out_path: Optional[str] = None) -> Optional[Plane]:
        self.slam.track_mono(img, timestamp)
        if self.plane is None or self.slam.map_changed():
            self.slam.flush()
            st = self.slam.state
            self.plane = detect_plane(_np(st.mp_pos), _np(st.mp_valid),
                                      _np(point_obs_count(st)))
        if out_path is not None:
            self.slam.flush()
            render_ar(img, _np(self.slam.ts.T),
                      _np(camera.intrinsics(self.slam.cfg.camera)),
                      self.plane, out_path, cube_size=self.cube_size,
                      status="SLAM" if self.slam.status == 2 else "LOST")
        return self.plane
