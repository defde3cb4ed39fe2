"""FAST-9/16 corner score and 3x3 NMS as dense tensor ops (port of
orb_slam2_tpu/frontend/fast.py).

These are the plain PyTorch forms.  They define the arithmetic the CUDA
kernel (csrc/fast_nms.cu) reproduces bit for bit, and they are what the
kernel's wrapper (frontend/fast_cuda.py) runs for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3: 16 (dy, dx) offsets, clockwise from the top.
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)
ARC_LEN = 9  # FAST-9


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[y, x] = img[y+dy, x+dx] (circular; the wrap lands in the
    border that fast_score_map zeroes)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_score_map(img: torch.Tensor, border: int = 3) -> torch.Tensor:
    """[H, W] corner score: the largest threshold t at which the pixel passes
    the FAST-9 segment test,

        score = max(max_r min_{k<9}(circle - Ip), max_r min_{k<9}(Ip - circle))

    over all 16 rotations r, clamped at 0, with a `border`-px zero band."""
    diffs = torch.stack([_shifted(img, int(dy), int(dx)) - img
                         for dy, dx in CIRCLE], dim=0)          # [16, H, W]

    def arc_min(d):
        acc = d
        for k in range(1, ARC_LEN):
            acc = torch.minimum(acc, torch.roll(d, -k, dims=0))
        return torch.amax(acc, dim=0)

    bright = arc_min(diffs)
    dark = arc_min(-diffs)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = ((ys >= border) & (ys < h - border) &
              (xs >= border) & (xs < w - border))
    return torch.where(inside, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep a pixel whose score is >= all 8
    neighbours (cv::FAST nonmaxSuppression=true)."""
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                m = torch.maximum(m, torch.roll(score, (dy, dx), dims=(0, 1)))
    return torch.where(score >= m, score, torch.zeros_like(score))
