"""Fixed-capacity keypoint sets and the extractor entry points (port of
orb_slam2_tpu/frontend/extractor.py): `build_extractor`, the level-atlas
formulation the SLAM path runs, and `build_extractor_perlevel`, the
per-level one kept for A/B comparison.

Per level, in the per-level formulation: FAST score map -> 3x3 NMS (the
CUDA kernel, one launch a level) -> dual threshold per 30 px cell ->
spatially balanced top-k (`_select_level`) -> IC angle and rotated BRIEF
on the blurred level -> coordinates scaled to level 0.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.config import ORBConfig
from orb_slam2_tpu_torch.frontend import fast, fast_cuda, orb, pyramid
from orb_slam2_tpu_torch.map.state import stable_topk


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
                    n_images: int = 1, return_atlas: bool = False,
                    frames: int = 1):
    """Return `extract(img [H, W] f32) -> Features` for a fixed image size
    (the level-atlas formulation, frontend/atlas.py), on `device`: CUDA
    unless the caller names one (raises without a card).  `n_images=2`
    batches a stereo pair ([2, H, W] -> Features [2, cap]);
    `return_atlas=True` also returns the raw level atlas; `frames`: the
    frames the images make (`build_atlas_extractor`)."""
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    return build_atlas_extractor(cfg, height, width, device=device,
                                 n_images=n_images, return_atlas=return_atlas,
                                 frames=frames)


def _select_level(score: torch.Tensor, quota: int, border: int,
                  n_grid: int):
    """Pick `quota` keypoints of a score map [h, w], spatially balanced:
    the winner of each of ~n_grid cells gets a 1e6 bonus, then one top-k
    (ties towards the lower index, as `lax.top_k`) takes the cell winners
    first and fills the quota with the best of the rest.

    Returns (xy [quota, 2] f32 level coords, resp [quota], valid [quota]).
    """
    h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = ((ys >= border) & (ys < h - border) &
              (xs >= border) & (xs < w - border))
    score = torch.where(inside, score, torch.zeros_like(score))

    gy = max(int(round(math.sqrt(n_grid * h / max(w, 1)))), 1)
    gx = max((n_grid + gy - 1) // gy, 1)
    cell_y = torch.clamp(ys * gy // h, 0, gy - 1)
    cell_x = torch.clamp(xs * gx // w, 0, gx - 1)
    flat_cell = (cell_y * gx + cell_x).reshape(-1)
    flat_score = score.reshape(-1)
    cell_max = torch.zeros(gy * gx, dtype=score.dtype, device=dev
                           ).scatter_reduce(0, flat_cell, flat_score, "amax",
                                            include_self=False)
    is_winner = (flat_score > 0) & (flat_score >= cell_max[flat_cell])
    priority = torch.where(flat_score > 0,
                           flat_score + is_winner.to(score.dtype) * 1e6,
                           -1.0)
    top, idx = stable_topk(priority, quota)
    valid = top > 0
    xy = torch.stack([idx % w, idx // w], -1).to(torch.float32)
    return xy, flat_score[idx], valid


def build_extractor_perlevel(cfg: ORBConfig, height: int, width: int,
                             device=None, use_kernel: bool = True):
    """Return `extract(img [H, W] f32) -> Features` in the per-level
    formulation (one chain of ops per pyramid level), on `device`: CUDA
    unless the caller names one (raises without a card).

    FAST+NMS runs through the CUDA kernel on the card (one launch a
    level) and through its plain version on the CPU; `use_kernel=False`
    runs the plain version on the card too (the A/B reference there, as
    JAX's `use_pallas=False`)."""
    quotas = per_level_quota(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    shapes = pyramid.level_shapes(height, width, cfg.n_levels,
                                  cfg.scale_factor)
    total = sum(quotas)
    pad = cfg.max_keypoints - total
    if pad < 0:
        raise ValueError(f"max_keypoints {cfg.max_keypoints} < quota sum "
                         f"{total}")
    weights = pyramid.cascade_weights(shapes, resolve_device(device))
    fast_fn = fast_cuda.fast_nms if use_kernel else \
        (lambda lv: fast_cuda.fast_nms_raw_plain(lv)[0])

    def extract(img: torch.Tensor) -> Features:
        if tuple(img.shape) != (height, width):
            raise ValueError(f"expected an image of shape {(height, width)}, "
                             f"got {tuple(img.shape)}")
        levels = pyramid.cascade(img, weights)
        out = []
        for lvl, (quota, lv_img) in enumerate(zip(quotas, levels)):
            if quota == 0:
                continue
            smap = fast.cell_threshold(fast_fn(lv_img), cfg.cell_size,
                                       float(cfg.ini_th_fast),
                                       float(cfg.min_th_fast))
            xy, resp, valid = _select_level(
                smap, quota, border=cfg.edge_threshold - 3, n_grid=quota)
            blurred = pyramid.gaussian_blur(lv_img, cfg.blur_ksize,
                                            cfg.blur_sigma)
            patches = orb.gather_patches(blurred, xy)
            ang = orb.ic_angle(patches)
            desc = orb.pack_bits(orb.brief_descriptors(patches, ang))
            octave = torch.full((quota,), lvl, dtype=torch.int32,
                                device=img.device)
            out.append((xy * cfg.scale_factor ** lvl, resp, octave, ang,
                        desc, valid))
        uv, resp, octv, ang, desc, valid = (torch.cat(a, 0)
                                            for a in zip(*out))
        if pad:
            uv, desc = (F.pad(a, (0, 0, 0, pad)) for a in (uv, desc))
            resp, octv, ang, valid = (F.pad(a, (0, pad))
                                      for a in (resp, octv, ang, valid))
        return Features(uv=uv, response=resp, octave=octv, angle=ang,
                        desc=desc, valid=valid)

    return extract
