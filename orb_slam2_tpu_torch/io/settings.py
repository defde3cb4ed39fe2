"""Reference-compatible YAML settings (port of orb_slam2_tpu/io/settings.py).

Reads the cv::FileStorage YAML files the reference ships
(Examples/**/*.yaml, parsed in Tracking.cc:53-147) and builds a SLAMConfig.
Missing keys default like the reference (silently 0 / fallback fps 30,
Tracking.cc:82-83).  OpenCV is not needed: `read_opencv_yaml` reads the
subset those files use — the `%YAML:1.0` header, `key: value` scalars, `#`
comments and `!!opencv-matrix` blocks whose `data: [...]` may run over
several lines.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Union

import numpy as np

from orb_slam2_tpu_torch import config as cfg_mod

# cv::FileStorage matrix element types
_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
       "i": np.int32, "f": np.float32, "d": np.float64}

Value = Union[float, int, str, np.ndarray]


def _scalar(text: str) -> Value:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _matrix(node: dict, key: str) -> np.ndarray:
    try:
        rows, cols, dt = int(node["rows"]), int(node["cols"]), str(node["dt"])
        data = node["data"]
    except KeyError as e:
        raise ValueError(f"{key}: opencv-matrix without {e}") from None
    if dt not in _DT:
        raise ValueError(f"{key}: unsupported opencv-matrix dt {dt!r}")
    arr = np.asarray(data, np.float64)
    if arr.size != rows * cols:
        raise ValueError(f"{key}: {arr.size} values for a {rows}x{cols} "
                         "matrix")
    return arr.astype(_DT[dt]).reshape(rows, cols)


def read_opencv_yaml(path: str) -> Dict[str, Value]:
    """Top-level keys of a cv::FileStorage YAML file: numbers as int or
    float, quoted or bare words as str, `!!opencv-matrix` nodes as numpy
    arrays of their `dt`.  Other nested mappings raise ValueError."""
    with open(path) as f:
        lines = [_strip_comment(ln).rstrip() for ln in f]
    out: Dict[str, Value] = {}
    i = 0
    # `key: value`; the reference's EuRoC.yaml also writes `data:[...]`
    key_re = re.compile(r"^([^:\s][^:]*?)\s*:(?:\s+|(?=\[)|$)(.*)$")
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.startswith("%") or \
                line.strip() == "---":
            continue
        if line[0].isspace():
            raise ValueError(f"{path}:{i}: unexpected indentation")
        m = key_re.match(line)
        if not m:
            raise ValueError(f"{path}:{i}: not a 'key: value' line: {line!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        tag = None
        if rest.startswith("!!"):
            tag, _, rest = rest.partition(" ")
            rest = rest.strip()
        if rest:
            out[key] = _scalar(rest)
            continue
        if tag != "!!opencv-matrix":
            raise ValueError(f"{path}:{i}: {key}: only !!opencv-matrix "
                             "nodes may nest")
        # the matrix's fields: the following indented lines
        node: Dict[str, Value] = {}
        while i < len(lines) and (not lines[i].strip() or
                                  lines[i][0].isspace()):
            sub = lines[i].strip()
            i += 1
            if not sub:
                continue
            sm = key_re.match(sub)
            if not sm:
                raise ValueError(f"{path}:{i}: not a 'key: value' line: "
                                 f"{sub!r}")
            skey, sval = sm.group(1), (sm.group(2) or "").strip()
            if sval.startswith("["):
                while "]" not in sval:
                    if i >= len(lines):
                        raise ValueError(f"{path}: {key}.{skey}: no closing "
                                         "']'")
                    sval += " " + lines[i].strip()
                    i += 1
                body = sval[1:sval.index("]")]
                node[skey] = [float(v) for v in body.replace(",", " ").split()]
            else:
                node[skey] = _scalar(sval)
        out[key] = _matrix(node, key)
    return out


def _read(fs: Dict[str, Value], key: str, default=0.0) -> float:
    """cv::FileNode::real() of a key, `default` when the key is absent."""
    if key not in fs:
        return default
    v = fs[key]
    return float(v) if isinstance(v, (int, float)) else 0.0


def load_settings(path: str, sensor: int) -> cfg_mod.SLAMConfig:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    fs = read_opencv_yaml(path)
    fps = _read(fs, "Camera.fps", 30.0) or 30.0
    width = int(_read(fs, "Camera.width", 640) or 640)
    height = int(_read(fs, "Camera.height", 480) or 480)
    cam = cfg_mod.CameraConfig(
        fx=_read(fs, "Camera.fx"), fy=_read(fs, "Camera.fy"),
        cx=_read(fs, "Camera.cx"), cy=_read(fs, "Camera.cy"),
        k1=_read(fs, "Camera.k1"), k2=_read(fs, "Camera.k2"),
        p1=_read(fs, "Camera.p1"), p2=_read(fs, "Camera.p2"),
        k3=_read(fs, "Camera.k3"),
        bf=_read(fs, "Camera.bf") if sensor != cfg_mod.MONOCULAR else 0.0,
        fps=fps, width=width, height=height,
        th_depth=_read(fs, "ThDepth", 35.0),
        depth_map_factor=_read(fs, "DepthMapFactor", 5000.0) or 1.0)
    n_feat = int(_read(fs, "ORBextractor.nFeatures", 1000) or 1000)
    # the engine's fixed array capacities (absent from the reference's
    # YAMLs, defaulted like every other key)
    max_kp = int(_read(fs, "TPU.maxKeypoints",
                       1 << max(9, math.ceil(math.log2(max(n_feat, 1))))))
    orb = cfg_mod.ORBConfig(
        n_features=n_feat,
        scale_factor=_read(fs, "ORBextractor.scaleFactor", 1.2) or 1.2,
        n_levels=int(_read(fs, "ORBextractor.nLevels", 8) or 8),
        ini_th_fast=int(_read(fs, "ORBextractor.iniThFAST", 20) or 20),
        min_th_fast=int(_read(fs, "ORBextractor.minThFAST", 7) or 7),
        max_keypoints=max_kp)
    tracking = cfg_mod.TrackingConfig(max_frames_hint=int(fps))
    cap = cfg_mod.Capacity(
        max_obs_per_kf=orb.max_keypoints,
        max_keyframes=int(_read(fs, "TPU.maxKeyframes", 512)),
        max_points=int(_read(fs, "TPU.maxPoints", 32768)),
        max_frames=int(_read(fs, "TPU.maxFrames", 8192)),
        local_ba_points=int(_read(fs, "TPU.localBAPoints", 8192)))
    return cfg_mod.SLAMConfig(sensor=sensor, camera=cam, orb=orb,
                              tracking=tracking, cap=cap)
