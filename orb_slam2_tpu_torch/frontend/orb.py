"""ORB patch geometry, the intensity-centroid angle, rotated BRIEF and bit
packing (port of orb_slam2_tpu/frontend/orb.py).  The atlas extractor takes
the pattern, mask and packing from here; the per-level extractor also the
patch gather, the angle and the descriptors.

The pattern is loaded from this package's own copy of
`data/brief_pattern.npy` (the learned 256-pair table); the descriptor bits
depend on it.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

PATCH = 31
HALF = 15
N_BITS = 256
_PATTERN_RADIUS = 13.0


def _load_pattern() -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (dy, dx)) test pattern."""
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "brief_pattern.npy")
    pat = np.load(path).astype(np.int32)
    if pat.shape != (N_BITS, 2, 2) or np.abs(pat).max() > _PATTERN_RADIUS:
        raise ValueError(f"malformed BRIEF pattern {path}: {pat.shape}")
    return pat


PATTERN = _load_pattern()

# circular-patch row half-widths for the intensity-centroid angle
_V = np.arange(-HALF, HALF + 1)
_UMAX_ROW = np.floor(np.sqrt(np.maximum(HALF * HALF - _V * _V, 0)) + 0.5
                     ).astype(np.int32)


def circular_mask() -> np.ndarray:
    """[31, 31] mask of the radius-15 circular patch."""
    yy, xx = np.meshgrid(_V, _V, indexing='ij')
    return (np.abs(xx) <= _UMAX_ROW[yy + HALF]).astype(np.float32)


_MASK = circular_mask()
_YY, _XX = np.meshgrid(_V, _V, indexing='ij')

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _table(name: str, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A constant table of this module (`_YY`, `_XX`, `_MASK`, `PATTERN`)
    as a tensor on `device`, copied there once (a host-to-card copy a call
    would wait for the card's queue each time)."""
    return torch.as_tensor(globals()[name], dtype=dtype, device=device)


def gather_patches(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[K, 31, 31] patches of img [H, W] around the rounded keypoints pts
    [K, 2] (x, y, this level's coords), centres clamped so every patch lies
    inside the image."""
    h, w = img.shape
    cy = torch.clamp(torch.round(pts[:, 1]).to(torch.int64), HALF,
                     h - HALF - 1)
    cx = torch.clamp(torch.round(pts[:, 0]).to(torch.int64), HALF,
                     w - HALF - 1)
    yy = _table("_YY", torch.int64, img.device)
    xx = _table("_XX", torch.int64, img.device)
    return img[cy[:, None, None] + yy[None], cx[:, None, None] + xx[None]]


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) of each [K, 31, 31] patch over
    the radius-15 circle (reference IC_Angle, ORBextractor.cc:77-104)."""
    f32 = lambda name: _table(name, torch.float32, patches.device)
    mask = f32("_MASK")
    m10 = torch.sum(patches * mask * f32("_XX"), dim=(1, 2))
    m01 = torch.sum(patches * mask * f32("_YY"), dim=(1, 2))
    return torch.atan2(m01, m10)


def brief_descriptors(patches: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF: [K, 31, 31] patches and [K] angles -> [K, 256] bits,
    bit = I(p1) < I(p2) at the pattern rotated by the angle and rounded to
    the nearest pixel (reference ORBextractor.cc:108-147)."""
    K = patches.shape[0]
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    pat = _table("PATTERN", torch.float32, patches.device)
    dy, dx = pat[..., 0][None], pat[..., 1][None]       # [1, 256, 2]
    rx = torch.round(dx * ca - dy * sa).to(torch.int64)
    ry = torch.round(dx * sa + dy * ca).to(torch.int64)
    iy = torch.clamp(ry + HALF, 0, PATCH - 1)
    ix = torch.clamp(rx + HALF, 0, PATCH - 1)
    idx = (iy * PATCH + ix).reshape(K, -1)              # [K, 512]
    samples = torch.gather(patches.reshape(K, -1), 1, idx
                           ).reshape(K, N_BITS, 2)
    return samples[..., 0] < samples[..., 1]


def bits_to_pm1(bits: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[K, 256] bool -> +-1 rows (Hamming distance as a matmul)."""
    return torch.where(bits, 1.0, -1.0).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 32] uint8 (little-endian bit order per byte)."""
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.uint8)
    w = _table("_BIT_WEIGHTS", torch.uint8, bits.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(packed[..., None],
                                                       shifts), 1)
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.bool)
