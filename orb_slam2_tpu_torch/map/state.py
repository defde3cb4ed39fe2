"""The map as a fixed-capacity NamedTuple of tensors (port of
orb_slam2_tpu/map/state.py).

Same fields, shapes and dtypes as the JAX `MapState`, so a JAX map converts
field by field (convert.py).  `kf_obs[k, n]` — the map-point id observed by
keypoint n of keyframe k — is the single source of truth; observation
counts, covisibility and the spanning tree derive from it.

Updates are functional: each returns a new MapState and leaves its input
untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.config import SLAMConfig


class MapState(NamedTuple):
    # --- keyframes (capacity K) ---
    kf_pose: torch.Tensor      # [K, 7] SE3 Tcw
    kf_valid: torch.Tensor     # [K] bool
    kf_frame_id: torch.Tensor  # [K] i32
    kf_timestamp: torch.Tensor  # [K] f32
    kf_parent: torch.Tensor    # [K] i32 spanning-tree parent (-1 root)
    kf_pose_rel: torch.Tensor  # [K, 7] pose relative to parent at cull time
    # --- per-keyframe keypoints (capacity K x N) ---
    kf_uv: torch.Tensor        # [K, N, 2]
    kf_ur: torch.Tensor        # [K, N]
    kf_depth: torch.Tensor     # [K, N]
    kf_octave: torch.Tensor    # [K, N] i32
    kf_angle: torch.Tensor     # [K, N] f32
    kf_desc: torch.Tensor      # [K, N, 32] u8
    kf_kp_valid: torch.Tensor  # [K, N] bool
    kf_obs: torch.Tensor       # [K, N] i32 map-point id (-1 none)
    # --- covisibility ---
    covis: torch.Tensor        # [K, K] i32 shared-observation counts
    loop_edge: torch.Tensor    # [K, K] bool
    # --- place recognition (unused on the vocabulary-free mono path) ---
    kf_bow: torch.Tensor       # [K, W] f32
    # --- map points (capacity M) ---
    mp_pos: torch.Tensor       # [M, 3]
    mp_valid: torch.Tensor     # [M] bool
    mp_desc: torch.Tensor      # [M, 32] u8
    mp_normal: torch.Tensor    # [M, 3]
    mp_min_dist: torch.Tensor  # [M]
    mp_max_dist: torch.Tensor  # [M]
    mp_first_kf: torch.Tensor  # [M] i32
    mp_visible: torch.Tensor   # [M] i32
    mp_found: torch.Tensor     # [M] i32
    mp_replaced: torch.Tensor  # [M] i32 forwarding id (-1 = live)
    mp_obs_kf: torch.Tensor    # [M, D] i32 observer table (-1 free)
    mp_obs_kp: torch.Tensor    # [M, D] i32
    # --- counters ---
    next_kf: torch.Tensor      # i32
    next_mp: torch.Tensor      # i32
    big_change: torch.Tensor   # i32

    @property
    def n_kf(self):
        return torch.sum(self.kf_valid.to(torch.int32))

    @property
    def n_mp(self):
        return torch.sum(self.mp_valid.to(torch.int32))


def empty_map(cfg: SLAMConfig, device=None) -> MapState:
    K = cfg.cap.max_keyframes
    N = cfg.cap.max_obs_per_kf
    M = cfg.cap.max_points
    D = cfg.cap.max_obs_per_point
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    pose0 = torch.zeros((K, 7), dtype=f32, **kw)
    pose0[:, 0] = 1.0
    return MapState(
        kf_pose=pose0,
        kf_valid=torch.zeros(K, dtype=torch.bool, **kw),
        kf_frame_id=torch.full((K,), -1, dtype=i32, **kw),
        kf_timestamp=torch.zeros(K, dtype=f32, **kw),
        kf_parent=torch.full((K,), -1, dtype=i32, **kw),
        kf_pose_rel=pose0.clone(),
        kf_uv=torch.zeros((K, N, 2), dtype=f32, **kw),
        kf_ur=torch.full((K, N), -1.0, dtype=f32, **kw),
        kf_depth=torch.full((K, N), -1.0, dtype=f32, **kw),
        kf_octave=torch.zeros((K, N), dtype=i32, **kw),
        kf_angle=torch.zeros((K, N), dtype=f32, **kw),
        kf_desc=torch.zeros((K, N, 32), dtype=torch.uint8, **kw),
        kf_kp_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_obs=torch.full((K, N), -1, dtype=i32, **kw),
        covis=torch.zeros((K, K), dtype=i32, **kw),
        loop_edge=torch.zeros((K, K), dtype=torch.bool, **kw),
        kf_bow=torch.zeros((K, cfg.vocab.branching ** cfg.vocab.depth),
                           dtype=f32, **kw),
        mp_pos=torch.zeros((M, 3), dtype=f32, **kw),
        mp_valid=torch.zeros(M, dtype=torch.bool, **kw),
        mp_desc=torch.zeros((M, 32), dtype=torch.uint8, **kw),
        mp_normal=torch.zeros((M, 3), dtype=f32, **kw),
        mp_min_dist=torch.zeros(M, dtype=f32, **kw),
        mp_max_dist=torch.zeros(M, dtype=f32, **kw),
        mp_first_kf=torch.full((M,), -1, dtype=i32, **kw),
        mp_visible=torch.ones(M, dtype=i32, **kw),
        mp_found=torch.ones(M, dtype=i32, **kw),
        mp_replaced=torch.full((M,), -1, dtype=i32, **kw),
        mp_obs_kf=torch.full((M, D), -1, dtype=i32, **kw),
        mp_obs_kp=torch.full((M, D), -1, dtype=i32, **kw),
        next_kf=torch.tensor(0, dtype=i32, **kw),
        next_mp=torch.tensor(0, dtype=i32, **kw),
        big_change=torch.tensor(0, dtype=i32, **kw),
    )


# ---------------------------------------------------------------------------
# scatter helpers: every write goes to a row of a buffer one slot longer
# than the table, so masked-off rows land in the sliced-off "void" slot
# ---------------------------------------------------------------------------

def mask_from_ids(ids: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool: True at ids[ok] (the `zeros.at[where(ok, ids, n)].set(True)`
    idiom).  All writes carry the same value, so duplicates are harmless."""
    m = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    m[torch.where(ok, ids.long(), n)] = True
    return m[:n]


def count_ids(ids: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int32 occurrence counts of ids[ok] (an integer scatter-add, which
    sums to the same result in any order)."""
    return torch.bincount(torch.where(ok, ids.long(), n).reshape(-1),
                          minlength=n + 1)[:n].to(torch.int32)


def last_writer(idx: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """[R] bool: row r is the last of the ok rows that target idx[r].

    Where a JAX `.at[idx].set(vals)` has repeated targets, the CPU backend
    the reference is tested on applies the updates in order, so the last one
    stands.  A CUDA scatter picks any of them; writing only the rows marked
    here gives the JAX result, and the same result every run."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where(ok, idx.long(), n)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device
                      ).scatter_reduce(0, tgt, torch.where(ok, rows, -1),
                                       "amax")
    return ok & (last[tgt] == rows)


def first_flagged(mask: torch.Tensor, P: int) -> torch.Tensor:
    """The first P indices where mask holds, in ascending order, padded with
    the first unflagged indices — `lax.top_k(mask.astype(int32), P)[1]`."""
    return torch.sort(mask.to(torch.int8), descending=True, stable=True
                      )[1][:P]


def stable_topk(x: torch.Tensor, k: int):
    """`lax.top_k` order: the k largest, ties towards the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def point_obs_count(state: MapState) -> torch.Tensor:
    """[M] number of keyframe observations per point (from kf_obs)."""
    M = state.mp_pos.shape[0]
    obs = state.kf_obs
    return count_ids(obs, state.kf_valid[:, None] & (obs >= 0), M)


def weighted_obs_count(state: MapState) -> torch.Tensor:
    """[M] nObs with stereo observations counted twice (reference
    MapPoint::AddObservation, MapPoint.cc:105-109)."""
    okf, okp = state.mp_obs_kf.long(), state.mp_obs_kp.long()
    ok = okf >= 0
    ur = state.kf_ur[okf.clamp(min=0), okp.clamp(min=0)]
    w = torch.where(ur >= 0, 2, 1)
    return torch.sum(torch.where(ok, w, 0), dim=1).to(torch.int32)


def update_covisibility_for_kf(state: MapState, k) -> MapState:
    """Recompute row/col k of the covisibility matrix: weight(k, j) = number
    of shared map points (reference KeyFrame::UpdateConnections)."""
    M = state.mp_pos.shape[0]
    obs = state.kf_obs
    obs_k = obs[k]
    mark = mask_from_ids(obs_k, obs_k >= 0, M + 1)
    mark[M] = False
    shared = torch.sum(mark[torch.where(obs >= 0, obs.long(), M)], dim=1
                       ).to(torch.int32)
    shared = torch.where(state.kf_valid, shared, 0)
    shared[k] = 0
    covis = state.covis.clone()
    covis[k, :] = shared
    covis[:, k] = shared
    return state._replace(covis=covis)


def spanning_parent_for_kf(state: MapState, k) -> torch.Tensor:
    """First-connection spanning-tree parent: the top covisible earlier KF."""
    w = state.covis[k]
    earlier = (torch.arange(w.shape[0], device=w.device) < k) & state.kf_valid
    w = torch.where(earlier, w, -1)
    parent = torch.argmax(w)
    return torch.where(torch.amax(w) > 0, parent, -1).to(torch.int32)


def covisible_neighbors(state: MapState, k, n: int,
                        min_weight: int = 1) -> torch.Tensor:
    """Top-n covisible KF ids of k by weight (-1 padded), ties towards the
    lower id (reference GetBestCovisibilityKeyFrames)."""
    w = torch.where(state.kf_valid, state.covis[k], 0)
    top_w, idx = stable_topk(w, n)
    return torch.where(top_w >= min_weight, idx, -1)


def resolve_replaced(state: MapState, pid: torch.Tensor) -> torch.Tensor:
    """Follow the replacement forwarding chain one hop."""
    fwd = state.mp_replaced[pid.long().clamp(min=0)]
    return torch.where((pid >= 0) & (fwd >= 0), fwd, pid)
