"""Fixed-capacity keypoint sets and the extractor entry point (port of
orb_slam2_tpu/frontend/extractor.py, the parts the atlas path uses)."""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from orb_slam2_tpu_torch.config import ORBConfig


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image."""
    uv: torch.Tensor        # [K, 2] float32 level-0 pixel coords (x, y), raw
    response: torch.Tensor  # [K] float32 FAST score
    octave: torch.Tensor    # [K] int32 pyramid level
    angle: torch.Tensor     # [K] float32 radians
    desc: torch.Tensor      # [K, 32] uint8 packed 256-bit descriptors
    valid: torch.Tensor     # [K] bool

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))


def per_level_quota(n_features: int, n_levels: int, scale: float) -> List[int]:
    """Geometric split of the keypoint budget over levels (reference
    ORBextractor.cc:437-450)."""
    inv = 1.0 / scale
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    quotas = [int(round(first * inv ** i)) for i in range(n_levels - 1)]
    quotas.append(max(n_features - sum(quotas), 0))
    return quotas


def build_extractor(cfg: ORBConfig, height: int, width: int, device=None,
                    n_images: int = 1, return_atlas: bool = False):
    """Return `extract(img [H, W] f32) -> Features` for a fixed image size
    (the level-atlas formulation, frontend/atlas.py), on `device`: CUDA
    unless the caller names one (raises without a card).  `n_images=2`
    batches a stereo pair ([2, H, W] -> Features [2, cap]);
    `return_atlas=True` also returns the raw level atlas."""
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    return build_atlas_extractor(cfg, height, width, device=device,
                                 n_images=n_images, return_atlas=return_atlas)
