"""Offline map / trajectory / frame rendering (port of
orb_slam2_tpu/viz/viewer.py).

The capability of the reference's Pangolin viewer (Viewer.cc:54-169,
MapDrawer.cc:44-228: map points, keyframe frusta, covisibility graph,
spanning tree, loop edges, camera track) and its FrameDrawer
(FrameDrawer.cc:38-165), rendered headlessly to PNG files.  Each renderer
is two functions: `*_scene` returns what it draws as primitives in data
coordinates (`viz/raster.py`: point sets, segments, colours, the status
text), with the JAX renderer's choices; `render_*` rasterises the scene
(numpy, no matplotlib) and writes the PNG.  Rendering runs on the host.

CLI: `tpu-slam-torch view --map map.npz --traj CameraTrajectory.txt --out map.png`
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam2_tpu_torch.io.png import write_png
from orb_slam2_tpu_torch.viz.raster import Line, Marks, Scene, Text, render


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _camera_centers(kf_pose: np.ndarray) -> np.ndarray:
    """[K, 7] Tcw (wxyz quat + t) -> camera centers C = -R^T t."""
    q = kf_pose[:, :4]
    t = kf_pose[:, 4:7]
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    # R^T v computed via conjugate quaternion rotation
    qc = np.stack([w, -x, -y, -z], -1)
    qv = qc[:, 1:]
    tt = 2 * np.cross(qv, t)
    return -(t + qc[:, :1] * tt + np.cross(qv, tt))


def _axes_of(kf_pose: np.ndarray, scale: float):
    """Per-KF forward (+z) direction in world coords, for frustum glyphs."""
    q = kf_pose[:, :4]
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    qc = np.stack([w, -x, -y, -z], -1)
    fwd = np.tile(np.array([0.0, 0.0, 1.0]), (len(q), 1))
    qv = qc[:, 1:]
    tt = 2 * np.cross(qv, fwd)
    return (fwd + qc[:, :1] * tt + np.cross(qv, tt)) * scale


def _xzy(p: np.ndarray) -> np.ndarray:
    """World points [N, 3] in the plot's axis order (x, z, -y), float64."""
    p = np.asarray(p)
    return np.stack([p[:, 0], p[:, 2], -p[:, 1]], -1).astype(np.float64)


def map_scene(state, traj: Optional[np.ndarray] = None,
              elev: float = -65.0, azim: float = -90.0, min_covis: int = 15,
              title: Optional[str] = None) -> Scene:
    """The primitives of `render_map`: map points, keyframe centres and
    their forward glyphs (scaled by 3% of the keyframes' extent),
    covisibility edges of weight >= `min_covis` (each unordered pair
    once), the spanning tree to valid parents, loop edges and the
    trajectory, in the axis order (x, z, -y)."""
    kf_pose = _np(state.kf_pose)
    kf_valid = _np(state.kf_valid).astype(bool)
    mp_pos = _np(state.mp_pos)
    mp_valid = _np(state.mp_valid).astype(bool)
    covis = _np(state.covis)
    loop_edge = _np(state.loop_edge)
    parent = _np(state.kf_parent)

    marks, lines = [], []
    pts = mp_pos[mp_valid]
    if len(pts):
        marks.append(Marks(_xzy(pts), "0.55", "o", 1.0, alpha=0.5,
                           label=f"{len(pts)} map points"))
    ks = np.nonzero(kf_valid)[0]
    C = _camera_centers(kf_pose)
    if len(ks):
        scale = max(np.ptp(C[ks], axis=0).max(), 1e-3) * 0.03
        Fw = _axes_of(kf_pose, scale)
        marks.append(Marks(_xzy(C[ks]), "tab:blue", "s", 14,
                           label=f"{len(ks)} keyframes"))
        for k in ks:
            lines.append(Line(_xzy(np.stack([C[k], C[k] + Fw[k]])),
                              "tab:blue", 0.7, alpha=0.8))
        # covisibility edges (DrawKeyFrames graph), k < j, row-major
        both = kf_valid[:, None] & kf_valid[None, :]
        ci, cj = np.nonzero(np.triu(both & (covis >= min_covis), 1))
        for k, j in zip(ci, cj):
            lines.append(Line(_xzy(C[[k, j]]), "tab:green", 0.4,
                              alpha=0.35))
        # spanning tree
        for k in ks:
            p = parent[k]
            if p >= 0 and kf_valid[p]:
                lines.append(Line(_xzy(C[[k, p]]), "0.3", 0.6, alpha=0.6))
        li, lj = np.nonzero(np.triu(loop_edge))
        for n, (k, j) in enumerate(zip(li, lj)):
            lines.append(Line(_xzy(C[[k, j]]), "tab:red", 1.6,
                              label="loop edge" if n == 0 else None))
    if traj is not None and len(traj):
        lines.append(Line(_xzy(np.asarray(traj)[:, 4:7]), "tab:orange", 1.2,
                          label="trajectory"))
    return Scene(size=(1430, 1170), dpi=130.0, axes="3d", marks=marks,
                 lines=lines, view=(elev, azim), labels=("x", "z", "-y"),
                 title=title, legend=True)


def render_map(state, out_path: str, traj: Optional[np.ndarray] = None,
               elev: float = -65.0, azim: float = -90.0,
               min_covis: int = 15, title: Optional[str] = None) -> str:
    """Render map points + keyframes + covisibility/spanning/loop edges
    (MapDrawer::DrawMapPoints/DrawKeyFrames, MapDrawer.cc:44-177) to a PNG.

    `state`: a MapState (tensors on any device, or numpy arrays); `traj`:
    optional [F, 7] Twc per-frame trajectory to overlay.  Returns out_path.
    """
    return write_png(out_path, render(map_scene(state, traj, elev, azim,
                                                min_covis, title)))


def status_text(status: int, n_kf: int, n_mp: int, n_matches: int,
                n_vo: int = 0, loc_only: bool = False) -> str:
    """The status bar (FrameDrawer::DrawTextInfo, FrameDrawer.cc:129-165)."""
    states = {0: "WAITING FOR IMAGES", 1: "TRYING TO INITIALIZE",
              2: "LOCALIZATION | " if loc_only else "SLAM MODE | ",
              3: "TRACK LOST"}
    s = states.get(int(status), "?")
    if int(status) == 2:
        s += (f"KFs: {int(n_kf)}, MPs: {int(n_mp)}, "
              f"Matches: {int(n_matches)}")
        if n_vo:
            s += f", + VO matches: {int(n_vo)}"
    return s


def frame_scene(img: np.ndarray, uv: np.ndarray, kp_valid: np.ndarray,
                pids: np.ndarray, status: int, n_kf: int, n_mp: int,
                vo_flags: Optional[np.ndarray] = None, loc_only: bool = False,
                title: Optional[str] = None) -> Scene:
    """The primitives of `render_frame`: untracked keypoints as faint dots,
    tracked map-point keypoints as lime hollow squares, VO points as blue
    ones, and the status bar in a 26 px band under the w x h image."""
    img = _np(img)
    uv = _np(uv)
    kp_valid = _np(kp_valid).astype(bool)
    pids = _np(pids)
    tracked = kp_valid & (pids >= 0)
    if vo_flags is not None:
        vo = kp_valid & _np(vo_flags).astype(bool) & ~tracked
    else:
        vo = np.zeros_like(tracked)
    plain = kp_valid & ~tracked & ~vo
    h, w = img.shape[:2]
    f64 = lambda a: np.asarray(a, np.float64)
    marks = []
    if plain.any():
        marks.append(Marks(f64(uv[plain]), "0.7", ".", 4))
    if tracked.any():
        marks.append(Marks(f64(uv[tracked]), "lime", "s", 22, filled=False,
                           width=0.9))
    if vo.any():
        marks.append(Marks(f64(uv[vo]), "deepskyblue", "s", 22,
                           filled=False, width=0.9))
    s = status_text(status, n_kf, n_mp, int(tracked.sum()), int(vo.sum()),
                    loc_only)
    return Scene(size=(w, h + 26), dpi=100.0, axes="image", marks=marks,
                 texts=[Text((4.0, h + 16.0), s, "black", 9.0, box="white")],
                 image=img, title=title)


def render_frame(img: np.ndarray, uv: np.ndarray, kp_valid: np.ndarray,
                 pids: np.ndarray, status: int, n_kf: int, n_mp: int,
                 out_path: str, vo_flags: Optional[np.ndarray] = None,
                 loc_only: bool = False, title: Optional[str] = None) -> str:
    """Current-frame render: keypoint overlay + status bar, a w x (h + 26)
    PNG (the headless FrameDrawer::DrawFrame/DrawTextInfo,
    FrameDrawer.cc:38-165).  Returns out_path."""
    return write_png(out_path, render(frame_scene(
        img, uv, kp_valid, pids, status, n_kf, n_mp, vo_flags, loc_only,
        title)))


def trajectory_scene(est_twc: np.ndarray, gt_twc: Optional[np.ndarray] = None,
                     title: Optional[str] = None) -> Scene:
    """The primitives of `render_trajectory`: the estimate's (x, z) and,
    dashed, the ground truth's."""
    e = _np(est_twc)
    lines = [Line(np.asarray(e[:, [4, 6]], np.float64), "tab:blue", 1.3,
                  label="estimate")]
    if gt_twc is not None and len(gt_twc):
        g = _np(gt_twc)
        lines.append(Line(np.asarray(g[:, [4, 6]], np.float64), "0.6", 1.0,
                          style="--", label="ground truth"))
    return Scene(size=(1040, 1040), dpi=130.0, axes="2d", lines=lines,
                 labels=("x [m]", "z [m]"), title=title, legend=True)


def render_trajectory(est_twc: np.ndarray, out_path: str,
                      gt_twc: Optional[np.ndarray] = None,
                      title: Optional[str] = None) -> str:
    """2D top-down (x-z) trajectory plot, optionally against ground truth;
    returns out_path."""
    return write_png(out_path, render(trajectory_scene(est_twc, gt_twc,
                                                       title)))
