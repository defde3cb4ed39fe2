"""Dense masked matchers (port of orb_slam2_tpu/matching/search.py).

Every matcher builds a gate mask [A, B], adds it to the dense Hamming matrix
as +inf, takes best and second-best per row, applies the distance threshold,
the Lowe ratio and the rotation-histogram filter, and keeps the closest row
per claimed column.  Matches are `idx [A] int` into B, -1 = unmatched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam2_tpu_torch.matching.hamming import hamming_matrix

INF = 1e9


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [A] int64 index into B, -1 if unmatched
    dist: torch.Tensor   # [A] int32 Hamming distance (meaningless where idx<0)

    @property
    def n(self):
        return torch.sum((self.idx >= 0).to(torch.int32))


def _best_two(masked_dist: torch.Tensor):
    """Per-row smallest and second-smallest of an [A, B] float matrix; the
    arg-min is the first minimal column."""
    best = torch.amin(masked_dist, dim=1)
    best_idx = torch.argmin(masked_dist, dim=1)
    without = masked_dist.scatter(1, best_idx[:, None], INF)
    second = torch.amin(without, dim=1)
    return best, best_idx, second


def resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor,
                       n_cols: int) -> torch.Tensor:
    """Keep only the lowest-distance row per claimed column (ties: the first
    row); the losers become -1."""
    dev = idx.device
    n_rows = idx.shape[0]
    has = idx >= 0
    claimed = torch.where(has, idx, 0)
    d = dist.to(torch.float32)
    col_min = torch.full((n_cols,), INF, device=dev).scatter_reduce(
        0, claimed, torch.where(has, d, INF), "amin")
    keep = has & (d <= col_min[claimed])
    order = torch.arange(n_rows, device=dev)
    first_row = torch.full((n_cols,), n_rows + 1, device=dev).scatter_reduce(
        0, claimed, torch.where(keep, order, n_rows + 1), "amin")
    keep = keep & (order == first_row[claimed])
    return torch.where(keep, idx, -1)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor,
                         idx: torch.Tensor, histo_length: int = 30
                         ) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 most popular
    of `histo_length` bins, and not in a bin under 0.1x the top bin
    (reference ComputeThreeMaxima, ORBmatcher.cc:1601-1642)."""
    matched = idx >= 0
    rot = angle_a - angle_b[torch.clamp(idx, min=0)]
    deg = torch.rad2deg(rot) % 360.0
    bin_f = deg * histo_length / 360.0
    bins = torch.clamp(bin_f.to(torch.int64), 0, histo_length - 1)
    counts = torch.zeros(histo_length, dtype=torch.int32,
                         device=idx.device).index_add_(
        0, bins, matched.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    keep_bin = (counts[:, None] == top3[None, :]).any(dim=1)
    keep_bin = keep_bin & (counts > 0.1 * top3[0])
    return torch.where(matched & keep_bin[bins], idx, -1)


def match_descriptors(dist: torch.Tensor, gate: torch.Tensor,
                      max_dist: float, ratio: Optional[float],
                      valid_a: torch.Tensor, valid_b: torch.Tensor
                      ) -> MatchResult:
    """Generic gated best match with an optional Lowe ratio test.
    dist: [A, B] int Hamming; gate: [A, B] bool allowed pairs."""
    allowed = gate & valid_a[:, None] & valid_b[None, :]
    md = torch.where(allowed, dist.to(torch.float32), INF)
    best, best_idx, second = _best_two(md)
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best < ratio * torch.clamp(second, max=INF - 1))
    idx = torch.where(ok, best_idx, -1)
    bi = best.to(torch.int32)
    idx = resolve_duplicates(idx, bi, dist.shape[1])
    return MatchResult(idx=idx, dist=bi)


def window_gate(uv_a: torch.Tensor, uv_b: torch.Tensor, radius) -> torch.Tensor:
    """[A, B] mask: |du| and |dv| within radius (scalar or per-row [A])."""
    du = torch.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dv = torch.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    r = radius[:, None] if torch.is_tensor(radius) and radius.dim() == 1 \
        else radius
    return (du <= r) & (dv <= r)


def octave_gate(oct_a_pred: torch.Tensor, oct_b: torch.Tensor,
                lo_off: int, hi_off: int) -> torch.Tensor:
    """[A, B] mask: keypoint octave within [pred+lo_off, pred+hi_off]."""
    o = oct_b[None, :]
    p = oct_a_pred[:, None]
    return (o >= p + lo_off) & (o <= p + hi_off)


def search_for_initialization(feat1_uv, feat1_desc, feat1_angle, feat1_oct,
                              feat1_valid, feat2_uv, feat2_desc, feat2_angle,
                              feat2_oct, feat2_valid, window: float,
                              max_dist: float, ratio: float,
                              check_rotation: bool = True) -> MatchResult:
    """Mono-init matcher (reference SearchForInitialization,
    ORBmatcher.cc:405-520), over all pyramid levels with an octave-equality
    gate, as the JAX package does."""
    dist = hamming_matrix(feat1_desc, feat2_desc)
    gate = window_gate(feat1_uv, feat2_uv, window)
    gate = gate & (feat1_oct[:, None] == feat2_oct[None, :])
    res = match_descriptors(dist, gate, max_dist, ratio, feat1_valid,
                            feat2_valid)
    idx = res.idx
    if check_rotation:
        idx = rotation_consistency(feat1_angle, feat2_angle, idx)
    return MatchResult(idx=idx, dist=res.dist)


def search_by_projection(pred_uv, pred_octave, pt_desc, pt_valid,
                         kp_uv, kp_oct, kp_desc, kp_angle, kp_valid,
                         radius_per_pt, max_dist: float,
                         ratio: Optional[float], oct_lo: int = -1,
                         oct_hi: int = 1) -> MatchResult:
    """Project-and-match (reference SearchByProjection family): window
    radius per point, octave band gate, threshold + optional ratio."""
    dist = hamming_matrix(pt_desc, kp_desc)
    gate = window_gate(pred_uv, kp_uv, radius_per_pt)
    gate = gate & octave_gate(pred_octave, kp_oct, oct_lo, oct_hi)
    return match_descriptors(dist, gate, max_dist, ratio, pt_valid, kp_valid)
