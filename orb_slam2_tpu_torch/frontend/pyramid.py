"""Pyramid level shapes, the antialiased bilinear resize and the Gaussian
blur taps (port of orb_slam2_tpu/frontend/pyramid.py plus the resize the
JAX atlas takes from `jax.image.resize(..., "bilinear")`).

`jax.image.resize` antialiases when it downsamples: it is a separable
scale-and-translate with a triangle kernel stretched by 1/scale.
`torch.nn.functional.interpolate` does not compute that filter, so the same
weight matrices are built here in numpy (float32, as JAX builds them) and
applied as two small matmuls: `out = Wh^T @ img @ Ww`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


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
