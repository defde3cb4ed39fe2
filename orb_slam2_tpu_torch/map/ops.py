"""Map mutation primitives (port of orb_slam2_tpu/map/ops.py, all but what
only loop closing calls).

Every change to the keypoint->point association goes through these, which
keep `kf_obs` and the capped observer mirror `mp_obs_kf/kp` consistent.
Scatters write into a buffer with one extra "void" row that masked-off
entries target and that is sliced off afterwards; the real targets of one
write are distinct, so the result does not depend on write order.

Each op is written over a leading sequence axis [S] on the state and on
its per-sequence arguments (keyframe ids [S], masks and rows [S, R]), as
JAX's `vmap` of the same op runs in the dp step; every op acts on each
sequence alone (integer counts, gathers and scatters within a sequence's
rows), so a sequence gets the bits it gets alone.  One sequence's state
goes through the same ops as S = 1 (`map.state.one_or_many`).
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.frontend.orb import unpack_bits
from orb_slam2_tpu_torch.map.state import (MapState, first_flagged,
                                           last_writer, one_or_many,
                                           seq_ids, seq_index, seq_put_row,
                                           seq_take, spanning_parent_for_kf,
                                           update_covisibility_for_kf)


def _void(t: torch.Tensor, fill) -> torch.Tensor:
    """The stacked t [S, R, ...] with one extra row (value `fill`) appended
    along the row axis."""
    pad = torch.full(t.shape[:1] + (1,) + tuple(t.shape[2:]), fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], 1)


def _fill_rows(t: torch.Tensor, rows: torch.Tensor, v) -> torch.Tensor:
    """Set rows[s, i] of each sequence's table t [S, R] to the scalar v in
    place (`index_fill_` takes the value as a scalar: setting a Python
    scalar by index would copy it from the host, which a CUDA graph cannot
    capture)."""
    flat = (seq_index(rows) * t.shape[1] + rows).reshape(-1)
    t.view(-1).index_fill_(0, flat, v)
    return t


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

@one_or_many
def alloc_points(state: MapState, want: torch.Tensor, pos: torch.Tensor,
                 desc: torch.Tensor, first_kf) -> tuple:
    """Allocate map points for rows where want[s, i] (append-only slab).
    Returns (state, pids [S, R] with -1 where not allocated)."""
    S, M = state.mp_valid.shape
    offs = torch.cumsum(want.to(torch.int32), -1) - 1
    pids = torch.where(want, state.next_mp[:, None] + offs, -1)
    ok = want & (pids < M)
    pids = torch.where(ok, pids, -1)
    slot = torch.where(ok, pids, M).long()
    ar = seq_index(slot)
    pos_p = _void(state.mp_pos, 0.0)
    desc_p = _void(state.mp_desc, 0)
    first_p = _void(state.mp_first_kf, -1)
    pos_p[ar, slot] = pos
    desc_p[ar, slot] = desc
    first_p[ar, slot] = seq_ids(first_kf, S, pos.device)[:, None].to(
        torch.int32)
    valid_p = _fill_rows(_void(state.mp_valid, False), slot, True)
    vis_p = _fill_rows(_void(state.mp_visible, 0), slot, 1)
    fnd_p = _fill_rows(_void(state.mp_found, 0), slot, 1)
    rep_p = _fill_rows(_void(state.mp_replaced, 0), slot, -1)
    n_new = torch.sum(ok, -1, dtype=torch.int32)
    state = state._replace(
        mp_pos=pos_p[:, :M], mp_desc=desc_p[:, :M], mp_valid=valid_p[:, :M],
        mp_first_kf=first_p[:, :M], mp_visible=vis_p[:, :M],
        mp_found=fnd_p[:, :M], mp_replaced=rep_p[:, :M],
        next_mp=state.next_mp + n_new)
    return state, pids.to(torch.int32)


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------

def _mirror_add(state: MapState, kf_ids, kp_idx, pids, ok):
    """Write one observer slot per point (its first free one) for rows ok
    ([S, R]; kf_ids [S, R] or [S, 1])."""
    M, D = state.mp_obs_kf.shape[-2:]
    free = state.mp_obs_kf < 0
    first_free = torch.argmax(free.to(torch.int8), dim=-1)
    has_free = torch.any(free, dim=-1)
    p = torch.where(ok, pids.long(), M).clamp(max=M - 1)
    slot = first_free.gather(-1, p)
    write = ok & has_free.gather(-1, p)
    # a point listed at two rows (two keypoints whose points forward to
    # one) claims its free slot twice: the later row stands, as JAX's
    # scatter leaves it on the CPU, and the same every run
    write = last_writer(p * D + slot, write, M * D)
    pr = torch.where(write, pids.long(), M)
    ar = seq_index(pr)
    obs_kf_p = _void(state.mp_obs_kf, -1)
    obs_kp_p = _void(state.mp_obs_kp, -1)
    obs_kf_p[ar, pr, slot] = torch.where(write, kf_ids, -1).to(torch.int32)
    obs_kp_p[ar, pr, slot] = torch.where(write, kp_idx, -1).to(torch.int32)
    return obs_kf_p[:, :M], obs_kp_p[:, :M]


@one_or_many
def add_obs(state: MapState, kf_id, kp_idx: torch.Tensor,
            pids: torch.Tensor) -> MapState:
    """Register observations (kf_id[s], kp_idx[s, i]) -> pids[s, i] for
    pids >= 0.  Each point may appear at most once per call."""
    S, N = state.kf_obs.shape[0], state.kf_obs.shape[-1]
    k = seq_ids(kf_id, S, pids.device)
    ok = pids >= 0
    kp = kp_idx.long().clamp(min=0)
    r = _void(seq_take(state.kf_obs, k), -1)                    # [S, N + 1]
    win = last_writer(kp, torch.ones_like(ok), N)   # every row writes
    v = torch.where(ok, pids.to(torch.int32), r.gather(-1, kp))
    r[seq_index(kp), torch.where(win, kp, N)] = v
    kf_obs = seq_put_row(state.kf_obs, k, r[:, :N])
    obs_kf, obs_kp = _mirror_add(state, k[:, None], kp_idx, pids, ok)
    return state._replace(kf_obs=kf_obs, mp_obs_kf=obs_kf, mp_obs_kp=obs_kp)


@one_or_many
def add_obs_multi(state: MapState, kf_ids: torch.Tensor, kp_idx: torch.Tensor,
                  pids: torch.Tensor) -> MapState:
    """Register observations (kf_ids[s, i], kp_idx[s, i]) -> pids[s, i]
    across many keyframes in one scatter.  (kf, kp) pairs are unique among
    active rows and each point appears at most once."""
    S, K_, N = state.kf_obs.shape
    ok = (pids >= 0) & (kf_ids >= 0)
    flat = torch.where(ok, kf_ids.long().clamp(min=0) * N +
                       kp_idx.long().clamp(min=0), K_ * N)
    kf_obs = _void(state.kf_obs.reshape(S, -1), -1)
    kf_obs[seq_index(flat), flat] = torch.where(ok, pids, -1).to(torch.int32)
    obs_kf, obs_kp = _mirror_add(state, kf_ids, kp_idx, pids, ok)
    return state._replace(kf_obs=kf_obs[:, :K_ * N].reshape(S, K_, N),
                          mp_obs_kf=obs_kf, mp_obs_kp=obs_kp)


@one_or_many
def remove_obs_global(state: MapState, removal: torch.Tensor) -> MapState:
    """Remove observations where removal [S, K, N] holds, from kf_obs and
    the mirror (e.g. BA outliers, reference Optimizer.cc:711-757)."""
    kf_obs = torch.where(removal, -1, state.kf_obs)
    okf, okp = state.mp_obs_kf, state.mp_obs_kp
    clear = (okf >= 0) & seq_take(removal, okf.long().clamp(min=0),
                                  okp.long().clamp(min=0))
    return state._replace(kf_obs=kf_obs,
                          mp_obs_kf=torch.where(clear, -1, okf),
                          mp_obs_kp=torch.where(clear, -1, okp))


@one_or_many
def remove_obs(state: MapState, kf_id, kp_mask: torch.Tensor) -> MapState:
    """Remove the observations of keyframe kf_id[s] at keypoints where
    kp_mask [S, N]."""
    k = seq_ids(kf_id, state.kf_obs.shape[0], kp_mask.device)
    removal = seq_put_row(torch.zeros_like(state.kf_kp_valid), k, kp_mask)
    return remove_obs_global(state, removal)


@one_or_many
def cull_points(state: MapState, bad: torch.Tensor) -> MapState:
    """Invalidate points where bad [S, M] and remove them from every
    keyframe's observation row (reference MapPoint::SetBadFlag)."""
    obs = state.kf_obs
    is_bad = seq_take(bad, obs.long().clamp(min=0)) & (obs >= 0)
    return state._replace(
        kf_obs=torch.where(is_bad, -1, obs),
        mp_valid=state.mp_valid & ~bad,
        mp_obs_kf=torch.where(bad[..., None], -1, state.mp_obs_kf),
        mp_obs_kp=torch.where(bad[..., None], -1, state.mp_obs_kp))


@one_or_many
def replace_points(state: MapState, src: torch.Tensor,
                   dst: torch.Tensor) -> MapState:
    """Fuse: forward every src point id to its dst (reference
    MapPoint::Replace).  src/dst [S, M]: src[s, i] >= 0 means point i is
    replaced by dst[s, i].  kf_obs references are rewritten, counters
    merged, i invalidated, existing forwarding chains collapsed."""
    S, M = state.mp_valid.shape
    fwd = torch.where(src >= 0, dst, -1)
    obs = state.kf_obs
    t = seq_take(fwd, obs.long().clamp(min=0))
    new_obs = torch.where((obs >= 0) & (t >= 0), t, obs)
    tgt = torch.where(fwd >= 0, fwd.long(), M)
    zeros = torch.zeros((S, M + 1), dtype=torch.int32, device=fwd.device)
    vis_add = zeros.scatter_add(-1, tgt, state.mp_visible)
    fnd_add = zeros.scatter_add(-1, tgt, state.mp_found)
    old_fwd = state.mp_replaced
    fo = fwd.gather(-1, old_fwd.long().clamp(min=0))
    collapsed = torch.where((old_fwd >= 0) & (fo >= 0), fo, old_fwd)
    replaced_mask = fwd >= 0
    return state._replace(
        kf_obs=new_obs.to(torch.int32),
        mp_valid=state.mp_valid & ~replaced_mask,
        mp_visible=state.mp_visible + vis_add[:, :M],
        mp_found=state.mp_found + fnd_add[:, :M],
        mp_replaced=torch.where(replaced_mask, fwd, collapsed).to(torch.int32),
        mp_obs_kf=torch.where(replaced_mask[..., None], -1, state.mp_obs_kf),
        mp_obs_kp=torch.where(replaced_mask[..., None], -1, state.mp_obs_kp))


# ---------------------------------------------------------------------------
# derived point attributes
# ---------------------------------------------------------------------------

def _center(pose: torch.Tensor) -> torch.Tensor:
    """Camera centre C = -R^T t of SE3 poses [..., 7]."""
    return -lie.quat_rotate(lie.quat_conj(pose[..., :4]), pose[..., 4:7])


@one_or_many
def update_point_attributes(state: MapState, pmask: torch.Tensor,
                            scale_factor: float, n_levels: int,
                            cap: int = 4096) -> MapState:
    """Recompute distinctive descriptor, normal and scale band for the
    points in pmask [S, M] from their observer table (reference
    MapPoint::ComputeDistinctiveDescriptors / UpdateNormalAndDepth).  The
    touched points are compacted into `cap` slots first."""
    S, M, D = state.mp_obs_kf.shape
    T = min(cap, M)
    sel = first_flagged(pmask, T)                            # [S, T]
    sel_ok = pmask.gather(-1, sel)
    okf = seq_take(state.mp_obs_kf, sel).long()              # [S, T, D]
    okp = seq_take(state.mp_obs_kp, sel).long()
    pos = seq_take(state.mp_pos, sel)                        # [S, T, 3]
    has = (okf >= 0) & sel_ok[..., None]
    kf_safe = okf.clamp(min=0)
    kp_safe = okp.clamp(min=0)

    descs = seq_take(state.kf_desc, kf_safe, kp_safe)        # [S, T, D, 32]
    pm1 = torch.where(unpack_bits(descs), 1.0, -1.0).reshape(S * T, D, 256)
    # +-1 products: every sum an integer, exact in any order
    dots = torch.bmm(pm1, pm1.transpose(1, 2)).reshape(S, T, D, D)
    dist = (256.0 - dots) * 0.5
    pair_ok = has[..., :, None] & has[..., None, :]
    dist = torch.where(pair_ok, dist, 0.0)
    cnt = torch.clamp(torch.sum(has, -1), min=1)[..., None]
    mean_d = torch.sum(dist, -1) / cnt
    mean_d = torch.where(has, mean_d, float("inf"))
    best = torch.argmin(mean_d, dim=-1)                      # [S, T]
    new_desc = descs.gather(2, best[..., None, None].expand(
        S, T, 1, descs.shape[-1]))[:, :, 0]

    centers = _center(seq_take(state.kf_pose, kf_safe))     # [S, T, D, 3]
    vec = pos[..., None, :] - centers
    nrm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    unit = torch.where(has[..., None], vec / torch.clamp(nrm, min=1e-9), 0.0)
    normal = torch.sum(unit, 2) / torch.clamp(torch.sum(has, -1), min=1
                                              )[..., None]
    ref_slot = torch.argmax(has.to(torch.int8), dim=-1)[..., None]
    ref_kf = kf_safe.gather(-1, ref_slot)[..., 0]
    ref_kp = kp_safe.gather(-1, ref_slot)[..., 0]
    d_ref = torch.linalg.vector_norm(
        pos - _center(seq_take(state.kf_pose, ref_kf)), dim=-1)
    octv = seq_take(state.kf_octave, ref_kf, ref_kp)
    level_sf = scale_factor ** octv.to(torch.float32)
    max_dist = d_ref * level_sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    upd = sel_ok & torch.any(has, -1)
    tgt = torch.where(upd, sel, M)
    ar = seq_index(tgt)

    def put(t, v):
        b = _void(t, 0)
        b[ar, tgt] = v.to(t.dtype)
        return b[:, :M]

    return state._replace(mp_desc=put(state.mp_desc, new_desc),
                          mp_normal=put(state.mp_normal, normal),
                          mp_max_dist=put(state.mp_max_dist, max_dist),
                          mp_min_dist=put(state.mp_min_dist, min_dist))


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------

@one_or_many
def insert_keyframe(state: MapState, frame, pose: torch.Tensor,
                    obs_pids: torch.Tensor):
    """Append a keyframe to each sequence's map, built from its tracked
    frame (a Frame with a leading [S] axis; reference
    Tracking::CreateNewKeyFrame + KeyFrame ctor + UpdateConnections).
    Returns (state, kf_id) with kf_id [S] int64: the slots are chosen on
    the device (`next_kf`), so nothing is read on the host."""
    S, N = frame.uv.shape[:2]
    dev = pose.device
    k = state.next_kf.long()

    def per_seq(v, dt):
        if not isinstance(v, torch.Tensor):
            return torch.full((S,), v, dtype=dt, device=dev)
        return v.to(dt).reshape(-1).expand(S)

    put = lambda t, v: seq_put_row(t, k, v)
    state = state._replace(
        kf_pose=put(state.kf_pose, pose),
        kf_valid=put(state.kf_valid, True),
        kf_frame_id=put(state.kf_frame_id,
                        per_seq(frame.frame_id, torch.int32)),
        kf_timestamp=put(state.kf_timestamp,
                         per_seq(frame.timestamp, torch.float32)),
        kf_uv=put(state.kf_uv, frame.uv),
        kf_ur=put(state.kf_ur, frame.ur),
        kf_depth=put(state.kf_depth, frame.depth),
        kf_octave=put(state.kf_octave, frame.octave),
        kf_angle=put(state.kf_angle, frame.angle),
        kf_desc=put(state.kf_desc, frame.desc),
        kf_kp_valid=put(state.kf_kp_valid, frame.valid),
        kf_obs=put(state.kf_obs, -1),
        next_kf=state.next_kf + 1)
    state = add_obs(state, k, torch.arange(N, device=dev).expand(S, N),
                    torch.where(frame.valid, obs_pids, -1))
    state = update_covisibility_for_kf(state, k)
    parent = spanning_parent_for_kf(state, k)
    state = state._replace(kf_parent=put(state.kf_parent, parent))
    return state, k
