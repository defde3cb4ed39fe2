"""The map as a fixed-capacity NamedTuple of tensors (port of
orb_slam2_tpu/map/state.py).

Same fields, shapes and dtypes as the JAX `MapState`, so a JAX map converts
field by field (convert.py).  `kf_obs[k, n]` — the map-point id observed by
keypoint n of keyframe k — is the single source of truth; observation
counts, covisibility and the spanning tree derive from it.

Updates are functional: each returns a new MapState and leaves its input
untouched, with one exception: `kf_bow`, whose table is GBs at the
reference's 10^6 words, has its rows written in place (`seq_put_row_`,
through `system.set_bow` and `mapping.cull_keyframe`).  Each of those
writers takes the mask `on` [S] of the sequences it may write, because
`seq_where(mask, new, old)` keeps an in-place write whatever the mask; and
`system._dense` puts a gathered batch's in-place writes back.  The helpers
below and the map ops (`map/ops.py`) are written
over a leading sequence axis [S] on every field (the dp step's stacked
states); one sequence's state goes through the same functions as S = 1
(`one_or_many`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

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
    kf_bow: torch.Tensor       # [K, W] f32, its rows written in place
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
        """Keyframes (per sequence of a stacked state)."""
        return torch.sum(self.kf_valid.to(torch.int32), dim=-1)

    @property
    def n_mp(self):
        """Map points (per sequence of a stacked state)."""
        return torch.sum(self.mp_valid.to(torch.int32), dim=-1)


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

def mask_from_ids(ids: torch.Tensor, ok: torch.Tensor, n: int,
                  seq: bool = False) -> torch.Tensor:
    """[n] bool: True at ids[ok] (the `zeros.at[where(ok, ids, n)].set(True)`
    idiom).  All writes carry the same value, so duplicates are harmless.
    With `seq`, ids [S, ...]: one mask per sequence, [S, n]."""
    lead = ids.shape[:1] if seq else ()
    tgt = torch.where(ok, ids.long(), n).reshape(lead + (-1,))
    return torch.zeros(lead + (n + 1,), dtype=torch.bool, device=ids.device
                       ).scatter_(-1, tgt, True)[..., :n]


def count_ids(ids: torch.Tensor, ok: torch.Tensor, n: int,
              seq: bool = False) -> torch.Tensor:
    """[n] int32 occurrence counts of ids[ok]: an integer scatter-add into a
    count of fixed length (exact in any order; `bincount` would read its
    length from the device).  With `seq`, ids [S, ...]: one count per
    sequence, [S, n]."""
    lead = ids.shape[:1] if seq else ()
    tgt = torch.where(ok, ids.long(), n).reshape(lead + (-1,))
    return torch.zeros(lead + (n + 1,), dtype=torch.int32, device=ids.device
                       ).scatter_add_(-1, tgt, torch.ones_like(
                           tgt, dtype=torch.int32))[..., :n]


# ---------------------------------------------------------------------------
# per-sequence rows of a stacked state (a leading [S] axis on every field)
# ---------------------------------------------------------------------------

def one_or_many(fn):
    """Let `fn`, written over a leading sequence axis [S] (a stacked
    MapState first, then per-sequence tensors: keyframe ids [S], masks
    [S, ...]), also take one sequence's state and tensors (no leading
    axis, keyframe ids as ints or 0-d tensors, as the session holds them):
    run it as S = 1 and return its results without the axis, every field
    it did not change as the caller's own tensor (fixed storage matches
    fields by identity)."""
    @functools.wraps(fn)
    def wrapped(state, *args, **kwargs):
        if state.next_kf.dim() == 1:
            return fn(state, *args, **kwargs)
        ins, spec = pytree.tree_flatten(((state,) + args, kwargs))
        one = [x[None] if isinstance(x, torch.Tensor) else x for x in ins]
        back = {id(b): a for a, b in zip(ins, one)
                if isinstance(a, torch.Tensor)}
        a, kw = pytree.tree_unflatten(one, spec)
        out = fn(*a, **kw)
        return pytree.tree_map(
            lambda x: back.get(id(x), x[0]) if isinstance(x, torch.Tensor)
            else x, out)
    return wrapped


_aranges = {}


def seq_index(idx: torch.Tensor) -> torch.Tensor:
    """arange(S) shaped [S, 1, ...] to broadcast against idx [S, ...]
    (made once per S and device, outside a graph capture)."""
    S = idx.shape[0]
    key = (S, idx.device)
    ar = _aranges.get(key)
    if ar is None:
        ar = torch.arange(S, device=idx.device)
        if not (idx.is_cuda and torch.cuda.is_current_stream_capturing()):
            _aranges[key] = ar
    return ar.view((S,) + (1,) * (idx.dim() - 1))


def seq_ids(k, S: int, device) -> torch.Tensor:
    """A keyframe id per sequence as int64 [S]: from [S], [S, 1], a 0-d or
    one-element tensor (the same id for every sequence) or an int."""
    if isinstance(k, torch.Tensor):
        k = k.long()
        return k.reshape(S) if k.numel() == S else k.reshape(()).expand(S)
    return torch.full((S,), k, dtype=torch.int64, device=device)


def seq_take(t: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """t[s, i[s], j[s], ...] for each sequence s: the per-sequence gather
    of a stacked table t [S, R, ...] by indices [S, ...] (one index
    tensor a table axis, broadcast together).  No host read."""
    return t[(seq_index(idx[0]),) + tuple(i.long() for i in idx)]


def seq_put_row(t: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """A copy of the stacked t [S, R, ...] with row k[s] of sequence s set
    to v[s] [S, ...] (or a Python scalar, broadcast to the rows), without
    a host read."""
    if not isinstance(v, torch.Tensor):
        v = torch.full(k.shape + t.shape[2:], v, dtype=t.dtype,
                       device=t.device)
    return t.index_put((seq_index(k), k.long()), v.to(t.dtype))


def seq_put_row_(t: torch.Tensor, k: torch.Tensor, v, on
                 ) -> torch.Tensor:
    """`seq_put_row` in place, for a table too wide to copy a write (the
    keyframes' BoW rows): row k[s] of sequence s set to v[s] where on[s]
    holds (every sequence where `on` is None), the others' rows rewritten
    with their own values.  Returns t."""
    if not isinstance(v, torch.Tensor):
        v = torch.full(k.shape + t.shape[2:], v, dtype=t.dtype,
                       device=t.device)
    idx = (seq_index(k), k.long())
    v = v.to(t.dtype)
    if on is not None:
        v = torch.where(on.view((-1,) + (1,) * (v.dim() - 1)), v, t[idx])
    return t.index_put_(idx, v)


def seq_put_col(t: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """A copy of the stacked t [S, R, C] with column k[s] of sequence s
    set to v[s] [S, R] (or a scalar)."""
    return seq_put_row(t.transpose(1, 2), k, v).transpose(1, 2)


def seq_where(mask: torch.Tensor, new, old):
    """Per sequence, `new`'s fields where mask [S] holds and `old`'s
    elsewhere (trees of the same structure with a leading [S] axis); a
    field whose tensor `new` did not replace stays `old`'s own.  At S = 1
    `new` itself: a branch under `control.cond` on `mask.any()` runs only
    when its one sequence takes it."""
    if mask.shape[0] == 1:
        return new

    def sel(a, b):
        if a is b or not isinstance(a, torch.Tensor):
            return b
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    return pytree.tree_map(sel, new, old)


def last_writer(idx: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """[..., R] bool: row r is the last of the ok rows that target idx[r]
    (along the last axis: per sequence of stacked indices).

    Where a JAX `.at[idx].set(vals)` has repeated targets, the CPU backend
    the reference is tested on applies the updates in order, so the last one
    stands.  A CUDA scatter picks any of them; writing only the rows marked
    here gives the JAX result, and the same result every run."""
    rows = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    tgt = torch.where(ok, idx.long(), n)
    last = torch.full(idx.shape[:-1] + (n + 1,), -1, dtype=torch.int64,
                      device=idx.device
                      ).scatter_reduce(-1, tgt, torch.where(ok, rows, -1),
                                       "amax")
    return ok & (last.gather(-1, tgt) == rows)


def set_last(n: int, idx: torch.Tensor, vals: torch.Tensor,
             fill) -> torch.Tensor:
    """[n, ...] `full(fill).at[idx].set(vals)`: rows with idx outside
    [0, n) write nowhere, and a target written twice keeps the later row
    (`last_writer`), as JAX does on the CPU, on any device."""
    ok = (idx >= 0) & (idx < n)
    win = last_writer(idx, ok, n)
    out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=idx.device)
    out[torch.where(win, idx.long(), n)] = vals
    return out[:n]


def first_flagged(mask: torch.Tensor, P: int) -> torch.Tensor:
    """The first P indices where mask holds, in ascending order, padded with
    the first unflagged indices — `lax.top_k(mask.astype(int32), P)[1]`
    (along the last axis: per sequence of a stacked mask)."""
    return torch.sort(mask.to(torch.int8), descending=True, stable=True
                      )[1][..., :P]


def stable_topk(x: torch.Tensor, k: int):
    """`lax.top_k` order: the k largest, ties towards the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# derived quantities, over a leading sequence axis [S] (`one_or_many`: or
# one sequence's state)
# ---------------------------------------------------------------------------

@one_or_many
def point_obs_count(state: MapState) -> torch.Tensor:
    """[S, M] number of keyframe observations per point (from kf_obs)."""
    M = state.mp_pos.shape[-2]
    obs = state.kf_obs
    return count_ids(obs, state.kf_valid[..., None] & (obs >= 0), M,
                     seq=True)


@one_or_many
def weighted_obs_count(state: MapState) -> torch.Tensor:
    """[S, M] nObs with stereo observations counted twice (reference
    MapPoint::AddObservation, MapPoint.cc:105-109)."""
    okf, okp = state.mp_obs_kf.long(), state.mp_obs_kp.long()
    ok = okf >= 0
    ur = seq_take(state.kf_ur, okf.clamp(min=0), okp.clamp(min=0))
    w = torch.where(ur >= 0, 2, 1)
    return torch.sum(torch.where(ok, w, 0), dim=-1).to(torch.int32)


@one_or_many
def update_covisibility_for_kf(state: MapState, k) -> MapState:
    """Recompute row/col k[s] of each sequence's covisibility matrix:
    weight(k, j) = number of shared map points (reference
    KeyFrame::UpdateConnections)."""
    S, K_ = state.kf_valid.shape
    M = state.mp_pos.shape[-2]
    k = seq_ids(k, S, state.kf_obs.device)
    obs = state.kf_obs
    obs_k = seq_take(obs, k)                                    # [S, N]
    mark = mask_from_ids(obs_k, obs_k >= 0, M + 1, seq=True)
    mark[:, M:].fill_(False)   # a scalar fill: no host-to-device copy
    shared = torch.sum(seq_take(mark, torch.where(obs >= 0, obs.long(), M)),
                       dim=-1).to(torch.int32)                  # [S, K]
    ids = torch.arange(K_, device=shared.device)
    shared = torch.where(state.kf_valid & (ids != k[:, None]), shared, 0)
    covis = seq_put_col(seq_put_row(state.covis, k, shared), k, shared)
    return state._replace(covis=covis)


@one_or_many
def spanning_parent_for_kf(state: MapState, k) -> torch.Tensor:
    """First-connection spanning-tree parent: the top covisible earlier KF
    ([S] int32)."""
    S, K_ = state.kf_valid.shape
    k = seq_ids(k, S, state.covis.device)
    w = seq_take(state.covis, k)
    earlier = (torch.arange(K_, device=w.device) < k[:, None]) & \
        state.kf_valid
    w = torch.where(earlier, w, -1)
    parent = torch.argmax(w, dim=-1)
    return torch.where(torch.amax(w, dim=-1) > 0, parent, -1).to(torch.int32)


@one_or_many
def covisible_neighbors(state: MapState, k, n: int,
                        min_weight: int = 1) -> torch.Tensor:
    """Top-n covisible KF ids of k by weight (-1 padded), ties towards the
    lower id (reference GetBestCovisibilityKeyFrames): [S, n]."""
    S = state.kf_valid.shape[0]
    k = seq_ids(k, S, state.covis.device)
    w = torch.where(state.kf_valid, seq_take(state.covis, k), 0)
    top_w, idx = stable_topk(w, n)
    return torch.where(top_w >= min_weight, idx, -1)


def resolve_replaced(state: MapState, pid: torch.Tensor) -> torch.Tensor:
    """Follow the replacement forwarding chain one hop (per sequence of a
    stacked state, pid [S, ...])."""
    safe = pid.long().clamp(min=0)
    rep = state.mp_replaced
    fwd = rep.gather(-1, safe.reshape(rep.shape[:-1] + (-1,))
                     ).reshape(pid.shape)
    return torch.where((pid >= 0) & (fwd >= 0), fwd, pid)
