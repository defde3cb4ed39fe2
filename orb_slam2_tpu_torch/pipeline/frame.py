"""Frame construction: features + keypoint undistortion (port of
orb_slam2_tpu/pipeline/frame.py, the monocular path)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera
from orb_slam2_tpu_torch.frontend.extractor import Features, build_extractor


class Frame(NamedTuple):
    uv: torch.Tensor        # [N, 2] undistorted keypoint coords
    uv_raw: torch.Tensor    # [N, 2] raw coords
    ur: torch.Tensor        # [N] stereo/virtual right u (-1 = none)
    depth: torch.Tensor     # [N] depth (-1 = none)
    octave: torch.Tensor    # [N] i32
    angle: torch.Tensor     # [N]
    desc: torch.Tensor      # [N, 32] u8
    valid: torch.Tensor     # [N] bool
    frame_id: torch.Tensor  # i32
    timestamp: torch.Tensor  # f32

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))


def _finish(cfg: SLAMConfig, feats: Features, ur, depth, frame_id, timestamp):
    dev = feats.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    d = camera.distortion(cfg.camera, dev)
    uv = camera.undistort_points(K, d, feats.uv)
    return Frame(uv=uv, uv_raw=feats.uv, ur=ur, depth=depth,
                 octave=feats.octave, angle=feats.angle, desc=feats.desc,
                 valid=feats.valid,
                 frame_id=torch.as_tensor(frame_id, dtype=torch.int32,
                                          device=dev),
                 timestamp=torch.as_tensor(timestamp, dtype=torch.float32,
                                           device=dev))


def build_mono_frame_fn(cfg: SLAMConfig, device=None):
    """Returns (image [H, W] f32, frame_id, timestamp) -> Frame, its
    extractor on `device`: CUDA unless the caller names one."""
    extract = build_extractor(cfg.orb, cfg.camera.height, cfg.camera.width,
                              device=device)

    def fn(img, frame_id, timestamp):
        feats = extract(img)
        n = feats.uv.shape[0]
        none = torch.full((n,), -1.0, device=img.device)
        return _finish(cfg, feats, none, none.clone(), frame_id, timestamp)

    return fn
