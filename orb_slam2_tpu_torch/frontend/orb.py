"""ORB patch geometry, the rotated-BRIEF test pattern and bit packing (port
of orb_slam2_tpu/frontend/orb.py, the subset the atlas extractor uses).

The pattern is loaded from this package's own copy of
`data/brief_pattern.npy` (the learned 256-pair table); the descriptor bits
depend on it.
"""

from __future__ import annotations

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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 32] uint8 (little-endian bit order per byte)."""
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.uint8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return torch.sum(b * w, dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(packed[..., None],
                                                       shifts), 1)
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.bool)
