"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (port of
orb_slam2_tpu/io/datasets.py).

Covers the reference's example loaders (mono_tum.cc:128-155 rgb.txt
parsing, rgbd_tum associations, stereo_kitti timestamp files, stereo_euroc
cam0/cam1 with online rectification).  Without OpenCV: images load through
`io/png.py`, the EuRoC undistort-rectify maps are computed in float64 numpy
as `cv2.initUndistortRectifyMap` computes them, and `remap_bilinear` samples
them bilinearly with a constant-0 border, as `cv2.remap(..., INTER_LINEAR)`
does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from orb_slam2_tpu_torch.io import png
from orb_slam2_tpu_torch.io.settings import read_opencv_yaml


@dataclasses.dataclass
class SequenceItem:
    timestamp: float
    rgb_path: Optional[str] = None
    depth_path: Optional[str] = None
    right_path: Optional[str] = None


def _imread_gray(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.imread_gray(path)


def _list_file(path: str) -> List[Tuple[float, str]]:
    """(timestamp, file) rows of a TUM list (rgb.txt, depth.txt)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, name = line.split()[:2]
            rows.append((float(t), name))
    return rows


def load_tum_mono(seq_dir: str) -> List[SequenceItem]:
    """Parse rgb.txt (reference LoadImages, mono_tum.cc:128-155)."""
    return [SequenceItem(timestamp=t, rgb_path=os.path.join(seq_dir, name))
            for t, name in _list_file(os.path.join(seq_dir, "rgb.txt"))]


def load_tum_rgbd(seq_dir: str, assoc_path: Optional[str] = None
                  ) -> List[SequenceItem]:
    """Parse an associations file (reference rgbd_tum.cc; README.md:157-167).
    If none is given, associate rgb.txt and depth.txt by nearest timestamp
    (<= 20 ms), as the TUM associate.py tool does."""
    if assoc_path and os.path.exists(assoc_path):
        items = []
        with open(assoc_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                items.append(SequenceItem(
                    timestamp=float(p[0]),
                    rgb_path=os.path.join(seq_dir, p[1]),
                    depth_path=os.path.join(seq_dir, p[3])))
        return items
    depth = _list_file(os.path.join(seq_dir, "depth.txt"))
    dts = np.asarray([d[0] for d in depth])
    items = []
    for it in load_tum_mono(seq_dir):
        j = int(np.argmin(np.abs(dts - it.timestamp)))
        if abs(dts[j] - it.timestamp) <= 0.02:
            items.append(SequenceItem(
                timestamp=it.timestamp, rgb_path=it.rgb_path,
                depth_path=os.path.join(seq_dir, depth[j][1])))
    return items


def load_kitti_stereo(seq_dir: str) -> List[SequenceItem]:
    """KITTI odometry layout: image_0/, image_1/, times.txt (reference
    stereo_kitti.cc LoadImages)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [SequenceItem(
        timestamp=t,
        rgb_path=os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
        right_path=os.path.join(seq_dir, "image_1", f"{i:06d}.png"))
        for i, t in enumerate(times)]


def load_euroc_stereo(seq_dir: str) -> List[SequenceItem]:
    """EuRoC mav0 layout: cam0/data, cam1/data with ns timestamps
    (reference stereo_euroc.cc)."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    items = []
    for n in sorted(os.listdir(cam0)):
        if not n.endswith(".png"):
            continue
        p1 = os.path.join(cam1, n)
        if os.path.exists(p1):
            items.append(SequenceItem(timestamp=float(n[:-4]) / 1e9,
                                      rgb_path=os.path.join(cam0, n),
                                      right_path=p1))
    return items


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) of a float32 image with
    float maps: exact bilinear weights, taps outside the image 0.  OpenCV
    5's remap is within 3.1e-5 of it on 0-255 images; OpenCV 4 rounds the
    coordinates to a 1/32 px grid first, which moves a pixel by up to ~2
    gray levels."""
    H, W = img.shape
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)
    ay = (map_y - y0).astype(np.float32)
    src = np.asarray(img, np.float32)

    def tap(y, x):
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        return np.where(ok, src[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)],
                        np.float32(0.0))

    return ((tap(y0, x0) * (1 - ax) + tap(y0, x0 + 1) * ax) * (1 - ay) +
            (tap(y0 + 1, x0) * (1 - ax) + tap(y0 + 1, x0 + 1) * ax) * ay
            ).astype(np.float32)


def init_undistort_rectify_map(K, D, R, P, size) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """cv2.initUndistortRectifyMap(K, D, R, P, (w, h), CV_32F) for the
    radial-tangential model (D = k1 k2 p1 p2 [k3 [k4 k5 k6]]): for each
    output pixel, the source pixel in the distorted image, in float64,
    returned as float32 [h, w] maps."""
    w, h = size
    K = np.asarray(K, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64)[:3, :3]
    R = np.asarray(R, np.float64).reshape(3, 3)
    d = np.zeros(8)
    dv = np.asarray(D, np.float64).reshape(-1)
    d[:min(len(dv), 8)] = dv[:8]
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    iR = np.linalg.inv(P @ R)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = u * iR[0, 0] + v * iR[0, 1] + iR[0, 2]
    Y = u * iR[1, 0] + v * iR[1, 1] + iR[1, 2]
    Z = u * iR[2, 0] + v * iR[2, 1] + iR[2, 2]
    x, y = X / Z, Y / Z
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / \
        (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    mx = K[0, 0] * xd + K[0, 2]      # OpenCV ignores the skew term
    my = K[1, 1] * yd + K[1, 2]
    return mx.astype(np.float32), my.astype(np.float32)


class SequenceReader:
    """Iterates (images..., timestamp) tuples with on-the-fly loading,
    optional depth scaling and stereo rectification."""

    def __init__(self, items: List[SequenceItem], sensor: str,
                 depth_factor: float = 5000.0, rectify=None):
        self.items = items
        self.sensor = sensor
        self.depth_factor = depth_factor
        self.rectify = rectify  # (map1x, map1y, map2x, map2y) or None

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Tuple]:
        for it in self.items:
            img = _imread_gray(it.rgb_path)
            if self.sensor == "mono":
                yield img, it.timestamp
            elif self.sensor == "rgbd":
                d = png.read_png(it.depth_path)
                yield img, d.astype(np.float32) / self.depth_factor, \
                    it.timestamp
            else:
                right = _imread_gray(it.right_path)
                if self.rectify is not None:
                    m1x, m1y, m2x, m2y = self.rectify
                    img = remap_bilinear(img, m1x, m1y)
                    right = remap_bilinear(right, m2x, m2y)
                yield img, right, it.timestamp


def euroc_rectify_maps(yaml_path: str):
    """Rectification maps from the LEFT./RIGHT. blocks of the reference's
    EuRoC stereo settings (Examples/Stereo/EuRoC.yaml:35-80)."""
    fs = read_opencv_yaml(yaml_path)
    size = (int(fs["LEFT.width"]), int(fs["LEFT.height"]))
    maps = []
    for side in ("LEFT", "RIGHT"):
        maps += init_undistort_rectify_map(
            fs[f"{side}.K"], fs[f"{side}.D"], fs[f"{side}.R"],
            fs[f"{side}.P"], size)
    return tuple(maps)
