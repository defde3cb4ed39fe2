"""Pyramid level shapes, the cascade pyramid, the antialiased bilinear
resize and the Gaussian blur (port of orb_slam2_tpu/frontend/pyramid.py
plus the resize the JAX atlas takes from `jax.image.resize(...,
"bilinear")`).

`jax.image.resize` antialiases when it downsamples: it is a separable
scale-and-translate with a triangle kernel stretched by 1/scale.
`torch.nn.functional.interpolate` does not compute that filter, so the same
weight matrices are built here in numpy (float32, as JAX builds them) and
applied as two small matmuls: `out = Wh^T @ img @ Ww`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(h: int, w: int, n_levels: int,
                 scale: float) -> List[Tuple[int, int]]:
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(n_levels)]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of JAX's antialiased bilinear resize along
    one axis (jax.image.scale_and_translate, translation 0)."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def cascade_weights(shapes: Sequence[Tuple[int, int]], device=None
                    ) -> List[Tuple[Optional[torch.Tensor],
                                    Optional[torch.Tensor]]]:
    """Per level i >= 1, the (rows, cols) resize weights from level i-1 on
    `device`; None for an axis whose size does not change (JAX skips it:
    an identity warp)."""
    out = []
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        out.append(tuple(
            torch.as_tensor(resize_weights(m, n), device=device)
            if m != n else None for m, n in ((h0, h1), (w0, w1))))
    return out


def cascade(img: torch.Tensor, weights) -> List[torch.Tensor]:
    """Level 0 and each level resized from the previous one with
    `cascade_weights`."""
    out = [img]
    for wh, ww in weights:
        x = out[-1]
        if wh is not None:
            x = wh.T @ x
        if ww is not None:
            x = x @ ww
        out.append(x)
    return out


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale: float) -> List[torch.Tensor]:
    """img [H, W] float32 in [0, 255] -> the per-level images; each level is
    resized from the previous one, like the reference (a cascade, not from
    level 0)."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    return cascade(img, cascade_weights(shapes, img.device))


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian with reflect padding: a sum of shifted rows, then
    of shifted columns, in JAX's order."""
    k = [float(v) for v in _gauss_kernel1d(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    rows = sum(x[i:i + H, :] * k[i] for i in range(ksize))
    y = F.pad(rows[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    return sum(y[:, i:i + W] * k[i] for i in range(ksize))
