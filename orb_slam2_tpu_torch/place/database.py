"""Keyframe database: loop-closure and relocalisation candidates (port of
orb_slam2_tpu/place/database.py).

The reference's per-word inverted file becomes a dense [K, W] BoW matrix in
the map state: shared-word counts, L1 scores and the covisibility-group
accumulation (the 0.8 / 0.75 gates of KeyFrameDatabase.cc:113-193) are
masked vector math over all keyframes.  The counts and scores come from
one `table_scores` call over the rows whose scores the gates can read
(on the card one kernel call that reads only those rows); the other rows
score 0 and are masked as before.  Every `lax.top_k` is
`map/state.stable_topk`, which keeps its lower-index tie order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.map.state import stable_topk
from orb_slam2_tpu_torch.place.vocab import table_scores

NEG_INF = float("-inf")


class CandidateResult(NamedTuple):
    ids: torch.Tensor     # [C] candidate keyframe ids (-1 padded)
    scores: torch.Tensor  # [C] their accumulated-group scores


def _top_k_pad(x: torch.Tensor, k: int):
    """Top k of a 1-D tensor, padded with -inf / -1 when k exceeds it."""
    n = x.shape[-1]
    vals, idx = stable_topk(x, min(k, n))
    if k > n:
        vals = torch.nn.functional.pad(vals, (0, k - n), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - n), value=-1)
    return vals, idx


def _group_candidates(kf_valid, covis, scores, cand, acc_frac: float,
                      n_out: int) -> CandidateResult:
    """Accumulate each candidate's score over its covisibility group (itself
    and its top-10 covisible keyframes), elect the group's best-scoring
    member, keep groups above acc_frac x the best, one entry per elected
    keyframe (KeyFrameDatabase.cc:147-193)."""
    K = kf_valid.shape[0]
    ar = torch.arange(K, device=scores.device)
    w = torch.where(kf_valid[None, :] & kf_valid[:, None], covis, 0)
    top_w, top_idx = stable_topk(w, min(10, K))                 # [K, <=10]
    member = cand[top_idx] & (top_w > 0)
    member_scores = torch.where(member, scores[top_idx], 0.0)
    acc = torch.where(cand, scores, 0.0) + torch.sum(member_scores, dim=1)
    member_val = torch.where(member, scores[top_idx], NEG_INF)
    member_arg = top_idx[ar, torch.argmax(member_val, dim=1)]
    self_score = torch.where(cand, scores, NEG_INF)
    best_of_group = torch.where(torch.amax(member_val, 1) > self_score,
                                member_arg, ar)
    acc = torch.where(cand, acc, NEG_INF)
    keep = acc > acc_frac * torch.amax(acc)
    rep = torch.where(keep, best_of_group, K)
    rep_score = torch.where(keep, acc, NEG_INF)
    # several groups may elect the same keyframe: keep its best score
    # (a max, so the order of the writes does not matter)
    seen = torch.full((K + 1,), NEG_INF, device=scores.device).scatter_reduce(
        0, rep, rep_score, "amax")[:K]
    top_s, top_i = _top_k_pad(seen, n_out)
    ids = torch.where(torch.isfinite(top_s), top_i, -1).to(torch.int32)
    return CandidateResult(ids=ids, scores=top_s)


def detect_loop_candidates(kf_bow: torch.Tensor, kf_valid: torch.Tensor,
                           covis: torch.Tensor, query, query_bow: torch.Tensor,
                           min_score: torch.Tensor, n_out: int = 8,
                           shared_frac: float = 0.8, acc_frac: float = 0.75,
                           min_weight_connected: int = 15) -> CandidateResult:
    """Loop candidates for keyframe `query` (reference DetectLoopCandidates,
    KeyFrameDatabase.cc:76-197)."""
    K = kf_bow.shape[0]
    ar = torch.arange(K, device=kf_bow.device)
    ok = kf_valid & (ar != query)
    # exclude directly connected keyframes (KeyFrameDatabase.cc:96)
    ok = ok & ~(covis[query] >= min_weight_connected)
    # only candidates' scores and counts are read: score the ok rows
    scores, sw = table_scores(query_bow, kf_bow, torch.where(ok, ar, -1))
    sw = torch.where(ok, sw, 0)
    min_cw = (shared_frac * torch.amax(sw)).to(sw.dtype)
    cand = ok & (sw > min_cw) & (sw > 0) & (scores >= min_score)
    return _group_candidates(kf_valid, covis, scores, cand, acc_frac, n_out)


def detect_reloc_candidates(kf_bow: torch.Tensor, kf_valid: torch.Tensor,
                            covis: torch.Tensor, query_bow: torch.Tensor,
                            n_out: int = 8, shared_frac: float = 0.8,
                            acc_frac: float = 0.75) -> CandidateResult:
    """Relocalisation candidates (reference DetectRelocalizationCandidates,
    KeyFrameDatabase.cc:199-309): the same pipeline without the min-score
    gate and the connection exclusion."""
    ar = torch.arange(kf_bow.shape[0], device=kf_bow.device)
    scores, sw = table_scores(query_bow, kf_bow,
                              torch.where(kf_valid, ar, -1))
    sw = torch.where(kf_valid, sw, 0)
    min_cw = (shared_frac * torch.amax(sw)).to(sw.dtype)
    cand = kf_valid & (sw > min_cw) & (sw > 0)
    return _group_candidates(kf_valid, covis, scores, cand, acc_frac, n_out)
