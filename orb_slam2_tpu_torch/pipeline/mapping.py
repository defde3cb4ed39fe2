"""Local mapping at keyframe rate: new-point triangulation, depth points of
a stereo/RGB-D keyframe, point fusion, point and keyframe culling (port of
orb_slam2_tpu/pipeline/mapping.py; reference LocalMapping.cc run
deterministically after a keyframe insertion).

Every function is written over a leading sequence axis [S] (the dp step's
stacked states, a keyframe id [S] a sequence), as JAX's `vmap` of the
same function runs there; one sequence's state goes through the same
functions as S = 1 (`map.state.one_or_many`).  Each sequence gets the
bits it gets alone: no float sum across [S], and every cuBLAS product
runs once a sequence (`core.seqwise`).  Where the JAX code `vmap`s over
neighbour keyframes, this port loops over every neighbour slot (a fixed
count, known when the step is built); a slot that is -1 (fewer covisible
keyframes than asked for) reads keyframe 0 and its results are masked
off, as in the JAX version.
Keyframe ids are device tensors: nothing here reads the device from the
host.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, control, lie, seqwise
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import (MapState, covisible_neighbors,
                                           first_flagged, last_writer,
                                           mask_from_ids, one_or_many,
                                           point_obs_count, seq_ids,
                                           seq_index, seq_put_col,
                                           seq_put_row, seq_put_row_,
                                           seq_take, seq_where, stable_topk,
                                           update_covisibility_for_kf,
                                           weighted_obs_count)
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline.init import pids_mask_from
from orb_slam2_tpu_torch.pipeline.tracking import predict_scale
from orb_slam2_tpu_torch.solvers import triangulate as tri

# Points `create_depth_points` made, and those of them under the close
# threshold, summed on the device in place beside the call (counted under
# graph replay too); `int(c)` reads one, `c.reset()` restarts it.
depth_points = control.Count()
close_depth_points = control.Count()


def _camera_center(T):
    return -lie.quat_rotate(lie.quat_conj(lie.se3_q(T)), lie.se3_t(T))


def _fundamental(T1, T2, K):
    """F [S, 3, 3] such that x2^T F x1 = 0 for pixel coords, from the
    poses [S, 7] of views 1 and 2 (reference LocalMapping::ComputeF12);
    the 3x3 products once a sequence (`seqwise.each`)."""
    T12 = lie.se3_compose(T1, lie.se3_inverse(T2))
    R = lie.quat_to_matrix(lie.se3_q(T12))
    one, zero = torch.ones((), device=K.device), torch.zeros((), device=K.device)
    Kinv = torch.stack([torch.stack([1.0 / K[0], zero, -K[2] / K[0]]),
                        torch.stack([zero, 1.0 / K[1], -K[3] / K[1]]),
                        torch.stack([zero, zero, one])])
    return seqwise.each(lambda h, r: Kinv.T @ (h @ r) @ Kinv,
                        lie.hat(lie.se3_t(T12)), R)


@one_or_many
def median_scene_depth(state: MapState, k, K) -> torch.Tensor:
    """Median depth of the points keyframe k[s] observes, [S]."""
    S = state.kf_obs.shape[0]
    k = seq_ids(k, S, state.kf_obs.device)
    obs = seq_take(state.kf_obs, k)                            # [S, N]
    has = obs >= 0
    pw = seq_take(state.mp_pos, obs.long().clamp(min=0))
    z = lie.se3_apply(seq_take(state.kf_pose, k)[:, None], pw)[..., 2]
    n = torch.clamp(torch.sum(has.to(torch.int32), -1), min=1)
    z_sorted = torch.sort(torch.where(has, z, float("inf")), -1)[0]
    mid = torch.clamp((n - 1) // 2, 0, z.shape[-1] - 1)
    return z_sorted.gather(-1, mid[:, None].long())[:, 0]


@one_or_many
def triangulate_new_points(state: MapState, kf_id, cfg: SLAMConfig,
                           n_neighbors: int | None = None) -> MapState:
    """Create map points by triangulating the new keyframe's unmatched
    keypoints against its best covisible neighbours (reference
    LocalMapping::CreateNewMapPoints); per keypoint the valid candidate with
    the largest parallax wins."""
    dev = state.kf_pose.device
    S, N = state.kf_obs.shape[0], state.kf_obs.shape[-1]
    K = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    kf_id = seq_ids(kf_id, S, dev)
    if n_neighbors is None:
        # 20 mono / 10 stereo-RGBD best covisible KFs (LocalMapping.cc:217)
        n_neighbors = (cfg.mapping.triangulate_neighbors if cfg.sensor == 0
                       else cfg.mapping.triangulate_neighbors_stereo)
    neighbors = covisible_neighbors(state, kf_id, n_neighbors, min_weight=15)
    T1 = seq_take(state.kf_pose, kf_id)                        # [S, 7]
    c1 = _camera_center(T1)
    med_depth = median_scene_depth(state, kf_id, K)
    kp1_free = seq_take(state.kf_kp_valid, kf_id) & \
        (seq_take(state.kf_obs, kf_id) < 0)
    desc1 = seq_take(state.kf_desc, kf_id)
    uv1 = seq_take(state.kf_uv, kf_id)                         # [S, N, 2]
    oct1 = seq_take(state.kf_octave, kf_id)
    ang1 = seq_take(state.kf_angle, kf_id)
    sigma1 = sf ** oct1.to(torch.float32)
    ones = torch.ones((S, N, 1), device=dev)
    ph1 = torch.cat([uv1, ones], -1)
    xn1 = (uv1 - K[2:4]) / K[:2]

    def per_neighbor(nb):
        nb_ok = nb >= 0
        nb = nb.clamp(min=0)
        T2 = seq_take(state.kf_pose, nb)
        c2 = _camera_center(T2)
        baseline = torch.linalg.vector_norm(c2 - c1, dim=-1)
        base_ok = baseline / torch.clamp(med_depth, min=1e-9) > 0.01
        kp2_free = seq_take(state.kf_kp_valid, nb) & \
            (seq_take(state.kf_obs, nb) < 0)
        uv2 = seq_take(state.kf_uv, nb)
        oct2 = seq_take(state.kf_octave, nb)
        F = _fundamental(T2, T1, K)
        ph2 = torch.cat([uv2, ones], -1)
        l2 = seqwise.each(lambda a, f: a @ f.T, ph1, F)
        num = (l2[:, :, None, :] * ph2[:, None, :, :]).sum(-1) ** 2
        den = torch.clamp(l2[..., 0:1] ** 2 + l2[..., 1:2] ** 2, min=1e-12)
        sigma2_2 = (sf ** oct2.to(torch.float32)) ** 2
        gate = num / den < 3.84 * sigma2_2[:, None, :]
        e2 = camera.project(K, lie.se3_apply(T2, c1))          # [S, 2]
        far = torch.sum((uv2 - e2[:, None]) ** 2, -1) > 100.0 * sigma2_2
        gate = gate & far[:, None, :]
        dist = hamming.hamming_matrix(desc1, seq_take(state.kf_desc, nb))
        res = search.match_descriptors(dist, gate, cfg.match.th_low, None,
                                       kp1_free, kp2_free)
        idx = search.rotation_consistency(ang1, seq_take(state.kf_angle, nb),
                                          res.idx, cfg.match.histo_length)
        m = idx >= 0
        idx_s = idx.clamp(min=0)
        uv2m = uv2.gather(1, idx_s[..., None].expand(S, N, 2))
        xn2 = (uv2m - K[2:4]) / K[:2]
        pw = tri.triangulate_dlt(T1[:, None], T2[:, None], xn1, xn2,
                                 per_seq=True)
        z1 = tri.depth_in(T1[:, None], pw)
        z2 = tri.depth_in(T2[:, None], pw)
        cosp = tri.parallax_cos(c1[:, None], c2[:, None], pw)
        chi1 = tri.reprojection_error(T1[:, None], K, pw, uv1) / torch.clamp(
            sigma1 ** 2, min=1e-9)
        chi2 = tri.reprojection_error(T2[:, None], K, pw, uv2m) / \
            sigma2_2.gather(1, idx_s)
        d1 = torch.linalg.vector_norm(pw - c1[:, None], dim=-1)
        d2 = torch.linalg.vector_norm(pw - c2[:, None], dim=-1)
        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        ratio_oct = sf ** (oct1 - oct2.gather(1, idx_s)).to(torch.float32)
        ratio_factor = 1.5 * sf
        scale_ok = (ratio_dist > ratio_oct / ratio_factor) & \
                   (ratio_dist < ratio_oct * ratio_factor)
        good = (m & nb_ok[:, None] & base_ok[:, None] &
                torch.all(torch.isfinite(pw), -1) &
                (cosp < 0.9998) & (cosp > 0) & (z1 > 0) & (z2 > 0) &
                (chi1 < cfg.mapping.epipolar_chi2_mono) &
                (chi2 < cfg.mapping.epipolar_chi2_mono) & scale_ok)
        return good, pw, idx, cosp

    # every slot; -1 slots trail the valid ones and add no good candidate,
    # so the argmax over all slots picks what it picks over the valid ones
    goods, pws, idxs, cosps = (torch.stack(a, 1) for a in zip(
        *[per_neighbor(neighbors[:, i]) for i in range(neighbors.shape[1])]))
    score = torch.where(goods, 1.0 - cosps, -1.0)          # [S, NB, N]
    best_nb = torch.argmax(score, dim=1)                   # [S, N]
    any_good = torch.any(goods, dim=1)
    pw_best = pws.gather(1, best_nb[:, None, :, None].expand(S, 1, N, 3)
                         )[:, 0]
    idx_best = idxs.gather(1, best_nb[:, None])[:, 0]
    nb_best = neighbors.gather(1, best_nb)

    state, pids = ops.alloc_points(state, any_good, pw_best,
                                   seq_take(state.kf_desc, kf_id), kf_id)
    ar = torch.arange(N, device=dev).expand(S, N)
    state = ops.add_obs(state, kf_id, ar, pids)
    state = ops.add_obs_multi(state, torch.where(pids >= 0, nb_best, -1),
                              idx_best.clamp(min=0), pids)
    state = ops.update_point_attributes(
        state, pids_mask_from(pids, state.mp_pos.shape[-2]),
        cfg.orb.scale_factor, cfg.orb.n_levels)
    return update_covisibility_for_kf(state, kf_id)


@one_or_many
def create_depth_points(state: MapState, kf_id, cfg: SLAMConfig,
                        active=None) -> MapState:
    """Stereo/RGB-D: map points for the new keyframe's untracked keypoints
    with depth, every close one and the nearest far ones until
    `close_depth_n` (reference Tracking::CreateNewKeyFrame,
    Tracking.cc:1078-1136).  `active` [S]: the sequences whose points the
    counts take (all by default)."""
    dev = state.kf_pose.device
    S, N = state.kf_obs.shape[0], state.kf_obs.shape[-1]
    K = camera.intrinsics(cfg.camera, dev)
    kf_id = seq_ids(kf_id, S, dev)
    depth = seq_take(state.kf_depth, kf_id)
    free = seq_take(state.kf_kp_valid, kf_id) & \
        (seq_take(state.kf_obs, kf_id) < 0)
    th_depth = cfg.camera.th_depth * cfg.camera.baseline \
        if cfg.camera.bf > 0 else float("inf")
    has = free & (depth > 0)
    # depth rank among the candidates; stable, so the inf-padded rest keeps
    # index order as in jnp.argsort
    order = torch.argsort(torch.where(has, depth, float("inf")), dim=-1,
                          stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    want = has & ((depth < th_depth) | (rank < cfg.tracking.close_depth_n))
    T = seq_take(state.kf_pose, kf_id)
    pc = camera.unproject(K, seq_take(state.kf_uv, kf_id), depth)
    pw = lie.se3_apply(lie.se3_inverse(T)[:, None], pc)
    state, pids = ops.alloc_points(state, want, pw,
                                   seq_take(state.kf_desc, kf_id), kf_id)
    state = ops.add_obs(state, kf_id, torch.arange(N, device=dev).expand(S, N),
                        pids)
    made = free & (seq_take(state.kf_obs, kf_id) >= 0)
    if active is not None:
        made = made & active[:, None]
    depth_points.add(made.sum())
    close_depth_points.add((made & (depth < th_depth)).sum())
    state = ops.update_point_attributes(
        state, pids_mask_from(pids, state.mp_pos.shape[-2]),
        cfg.orb.scale_factor, cfg.orb.n_levels)
    return update_covisibility_for_kf(state, kf_id)


@one_or_many
def cull_points(state: MapState, kf_id, cfg: SLAMConfig) -> MapState:
    """Recent-point culling (reference LocalMapping::MapPointCulling): found
    ratio < 0.25, or too few observations two keyframes after creation;
    points of the two bootstrap keyframes are exempt."""
    S = state.kf_obs.shape[0]
    cnt = point_obs_count(state)
    found_ratio = state.mp_found.to(torch.float32) / \
        torch.clamp(state.mp_visible, min=1).to(torch.float32)
    age = seq_ids(kf_id, S, cnt.device)[:, None] - state.mp_first_kf
    min_obs = 2 if cfg.sensor == 0 else cfg.mapping.cull_min_obs
    bad = state.mp_valid & (
        (found_ratio < cfg.mapping.found_ratio_min) |
        ((age >= 2) & (cnt <= min_obs)))
    bad = bad & (age <= 3) & (state.mp_first_kf >= 2)
    return ops.cull_points(state, bad)


@one_or_many
def cull_keyframe(state: MapState, ts, c, cfg: SLAMConfig, on):
    """Invalidate keyframe c[s] of each sequence (reference
    KeyFrame::SetBadFlag): erase its observations (discarding points left
    with nObs <= 2), re-parent its children by max covisibility, store the
    relative pose, and retarget the trajectory records that referenced it
    to its parent.  `c`: ids >= 0 ([S], or an int / 0-d tensor for every
    sequence).  The BoW row is cleared in place, for the sequences where
    `on` [S] holds (all where it is None): a caller that keeps some
    sequences' old state names the others.  Returns (state, ts)."""
    S, K = state.kf_valid.shape
    M = state.mp_pos.shape[-2]
    dev = state.kf_pose.device
    c = seq_ids(c, S, dev)
    parent = seq_take(state.kf_parent, c)
    parent = torch.where(parent >= 0, parent, 0).to(torch.int32)
    rel_cp = lie.se3_compose(seq_take(state.kf_pose, c),
                             lie.se3_inverse(seq_take(state.kf_pose, parent)))
    pids = seq_take(state.kf_obs, c)
    touched = mask_from_ids(pids, pids >= 0, M, seq=True)
    state = ops.remove_obs(state, c, torch.ones(
        (S, state.kf_obs.shape[-1]), dtype=torch.bool, device=dev))
    w_cnt = weighted_obs_count(state)
    state = ops.cull_points(state, touched & state.mp_valid & (w_cnt <= 2))
    state = state._replace(
        kf_valid=seq_put_row(state.kf_valid, c, False),
        covis=seq_put_col(seq_put_row(state.covis, c, 0), c, 0),
        kf_bow=seq_put_row_(state.kf_bow, c, 0.0, on),
        kf_pose_rel=seq_put_row(state.kf_pose_rel, c, rel_cp))
    ids = torch.arange(K, device=dev)
    children = state.kf_parent == c[:, None]
    w = torch.where(state.kf_valid[:, None, :] &
                    (ids[None, :] < ids[:, None]), state.covis, -1)
    best = torch.argmax(w, dim=-1).to(torch.int32)
    new_par = torch.where(torch.amax(w, dim=-1) > 0, best, parent[:, None])
    state = state._replace(
        kf_parent=torch.where(children, new_par, state.kf_parent))
    hit = ts.traj[..., 14].to(torch.int32) == c[:, None]
    rel2 = lie.se3_compose(ts.traj[..., 7:14], rel_cp[:, None])
    traj = ts.traj.clone()
    traj[..., 7:14] = torch.where(hit[..., None], rel2, ts.traj[..., 7:14])
    traj[..., 14] = torch.where(hit, parent[:, None].to(torch.float32),
                                traj[..., 14])
    return state, ts._replace(traj=traj)


@one_or_many
def cull_redundant_keyframes(state: MapState, ts, kf_id,
                             cfg: SLAMConfig, n_candidates: int = 10,
                             active=None):
    """Reference LocalMapping::KeyFrameCulling: a covisible keyframe is
    redundant if >90% of its points (its close points for stereo/RGB-D) are
    seen by >= 3 other keyframes at the same or finer scale; the most
    redundant one is culled, under a device branch on "some sequence
    culls" with each sequence keeping its own result (JAX mapping.py:324,
    under vmap).  `active` [S]: the sequences that may cull (all by
    default).  Returns (state, ts)."""
    S = state.kf_obs.shape[0]
    kf_id = seq_ids(kf_id, S, state.kf_obs.device)
    th_obs = cfg.mapping.kf_cull_th_obs
    cands = covisible_neighbors(state, kf_id, n_candidates, min_weight=15)
    csafe = cands.clamp(min=0)                               # [S, C]
    pids = seq_take(state.kf_obs, csafe)                     # [S, C, N]
    valid = pids >= 0
    if cfg.sensor != 0:
        # only close stereo points count (LocalMapping.cc:657-661)
        d = seq_take(state.kf_depth, csafe)
        valid = valid & (d > 0) & \
            (d < cfg.camera.th_depth * cfg.camera.baseline)
    safe = pids.long().clamp(min=0)
    okf = seq_take(state.mp_obs_kf, safe).long()             # [S, C, N, D]
    okp = seq_take(state.mp_obs_kp, safe).long()
    o_ok = okf >= 0
    kfs, kps = okf.clamp(min=0), okp.clamp(min=0)
    obs_oct = seq_take(state.kf_octave, kfs, kps)
    wgt = torch.where(seq_take(state.kf_ur, kfs, kps) >= 0, 2, 1)
    tot_w = torch.sum(torch.where(o_ok, wgt, 0), dim=-1)
    scale = seq_take(state.kf_octave, csafe)
    fine = o_ok & (okf != csafe[..., None, None]) & \
        (obs_oct <= scale[..., None] + 1)
    n_fine = torch.sum(fine.to(torch.int32), dim=-1)
    red = valid & (tot_w > th_obs) & (n_fine >= th_obs)
    nmp = torch.sum(valid.to(torch.int32), dim=-1)
    nred = torch.sum(red.to(torch.int32), dim=-1)
    ratio = nred / torch.clamp(nmp, min=1).to(torch.float32)
    culls = ((cands > 0) & (cands != kf_id[:, None]) & (nmp > 0) &
             (nred > cfg.mapping.kf_cull_redundancy * nmp))
    bi = torch.argmax(torch.where(culls, ratio, -1.0), dim=-1)[:, None]
    c = torch.where(culls.gather(1, bi), cands.gather(1, bi), -1)[:, 0]
    do = c >= 0 if active is None else (c >= 0) & active
    return control.cond(
        do.any(), lambda st, t: seq_where(
            do, cull_keyframe(st, t, c.clamp(min=0), cfg, do), (st, t)),
        control.identity, (state, ts))


def _apply_fuse_onepass(state: MapState, tgt_kf, tgt_ok, kp_a, m_a,
                        pids0) -> MapState:
    """Direction-A fuse bookkeeping for all targets in one batched pass
    (ORBmatcher::Fuse add/merge semantics).  tgt_kf [S, T] target
    keyframes, tgt_ok [S, T], kp_a/m_a [S, T, N] matched keypoint per
    source row, pids0 [S, N] the new KF's point per row.  The lowest
    proposal index wins a contested target keypoint, one merge per loser,
    and a point that loses anywhere in the pass neither adds nor wins."""
    S, K_, N = state.kf_obs.shape
    M, D = state.mp_obs_kf.shape[-2:]
    T = tgt_kf.shape[1]
    KN = K_ * N
    dev = tgt_kf.device
    flat = lambda x: x.reshape(S, -1)

    cnt = point_obs_count(state)
    kp = kp_a.clamp(min=0)
    src_pid = torch.where(m_a & tgt_ok[..., None],
                          pids0.long()[:, None].expand(S, T, N), -1)
    psafe = src_pid.clamp(min=0)
    src_ok = (src_pid >= 0) & seq_take(state.mp_valid, psafe)
    existing = seq_take(state.kf_obs, tgt_kf[..., None], kp).long()
    ex_safe = existing.clamp(min=0)
    add_case = src_ok & (existing < 0)
    merge_case = src_ok & (existing >= 0) & (existing != src_pid) & \
        seq_take(state.mp_valid, ex_safe)

    prop = (torch.arange(T, device=dev)[:, None] * N +
            torch.arange(N, device=dev)[None, :]).expand(S, T, N)
    key = tgt_kf[..., None] * N + kp
    any_case = add_case | merge_case
    claim = torch.full((S, KN + 1), T * N, dtype=torch.int64, device=dev
                       ).scatter_reduce(1, flat(torch.where(any_case, key,
                                                            KN)),
                                        flat(prop), "amin")[:, :KN]
    keep = any_case & (seq_take(claim, key) == prop)
    add_case = add_case & keep
    merge_case = merge_case & keep

    src_bigger = seq_take(cnt, psafe) >= seq_take(cnt, ex_safe)
    loser = torch.where(src_bigger, existing, src_pid)
    winner = torch.where(src_bigger, src_pid, existing)
    lsafe = loser.clamp(min=0)
    lclaim = torch.full((S, M + 1), T * N, dtype=torch.int64, device=dev
                        ).scatter_reduce(1, flat(torch.where(merge_case,
                                                             lsafe, M)),
                                         flat(prop), "amin")[:, :M]
    mkeep = merge_case & (seq_take(lclaim, lsafe) == prop)
    loser_set = mask_from_ids(lsafe, mkeep, M, seq=True)
    mkeep = mkeep & ~seq_take(loser_set, winner.clamp(min=0))
    loser_set = mask_from_ids(lsafe, mkeep, M, seq=True)
    ltgt = flat(torch.where(mkeep, lsafe, M))
    ar = seq_index(ltgt)
    src_arr = torch.full((S, M + 1), -1, dtype=torch.int64, device=dev)
    dst_arr = torch.full((S, M + 1), -1, dtype=torch.int64, device=dev)
    src_arr[ar, ltgt] = flat(torch.where(mkeep, loser, -1))
    dst_arr[ar, ltgt] = flat(torch.where(mkeep, winner, -1))
    src_arr, dst_arr = src_arr[:, :M], dst_arr[:, :M]
    src_arr = torch.where(src_arr == torch.arange(M, device=dev), src_arr, -1)

    # adds: a losing point does not add; write kf_obs + ranked mirror slots
    add_case = add_case & ~seq_take(loser_set, psafe)
    kf_obs = torch.cat([flat(state.kf_obs), torch.full(
        (S, 1), -1, dtype=torch.int32, device=dev)], 1)
    kt = flat(torch.where(add_case, key, KN))
    kf_obs[seq_index(kt), kt] = flat(torch.where(add_case, src_pid, -1)
                                     ).to(torch.int32)
    # each source point's adds ranked over the targets
    rank = torch.cumsum(add_case.to(torch.int64), dim=1) - 1
    free = state.mp_obs_kf < 0
    free_order = torch.argsort((~free).to(torch.int8), dim=-1, stable=True)
    n_free = torch.sum(free.to(torch.int64), dim=-1)
    slot = seq_take(free_order, psafe, rank.clamp(0, D - 1))
    can = add_case & (rank < seq_take(n_free, psafe))
    # a point listed at two source rows claims one slot twice; the later
    # write stands, as on the reference's CPU backend
    can = last_writer(flat(psafe * D + slot), flat(can), M * D
                      ).reshape(S, T, N)
    pr = torch.where(can, psafe, M)
    obs_kf = torch.cat([state.mp_obs_kf, torch.full(
        (S, 1, D), -1, dtype=torch.int32, device=dev)], 1)
    obs_kp = torch.cat([state.mp_obs_kp, torch.full(
        (S, 1, D), -1, dtype=torch.int32, device=dev)], 1)
    sq = seq_index(pr)
    obs_kf[sq, pr, slot] = torch.where(can, tgt_kf[..., None].expand(S, T, N),
                                       -1).to(torch.int32)
    obs_kp[sq, pr, slot] = torch.where(
        can, torch.arange(N, device=dev).expand(S, T, N),
        -1).to(torch.int32)
    state = state._replace(kf_obs=kf_obs[:, :KN].reshape(S, K_, N),
                           mp_obs_kf=obs_kf[:, :M], mp_obs_kp=obs_kp[:, :M])
    return ops.replace_points(state, src_arr, dst_arr)


@one_or_many
def fuse_neighbors(state: MapState, kf_id, cfg: SLAMConfig,
                   n_neighbors: int | None = None) -> MapState:
    """Two-way map-point fusion with covisible neighbours (reference
    LocalMapping::SearchInNeighbors + ORBmatcher::Fuse).  Direction A
    projects the new KF's points into every target, direction B the
    targets' points into the new KF; matched free keypoints gain the
    observation, occupied ones merge towards the point with more
    observations.  Descriptors/normals and the covisibility row are then
    refreshed."""
    dev = state.kf_pose.device
    S, K_, N = state.kf_obs.shape
    K = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    M = state.mp_pos.shape[-2]
    kf_id = seq_ids(kf_id, S, dev)
    radius_base = cfg.mapping.fuse_radius
    if n_neighbors is None:
        n_neighbors = cfg.mapping.fuse_neighbors

    neighbors = covisible_neighbors(state, kf_id, n_neighbors, min_weight=15)
    n2 = cfg.mapping.fuse_neighbors_second
    if n2 > 0:
        nb_ok = neighbors >= 0
        w2 = torch.amax(torch.where(nb_ok[..., None],
                                    seq_take(state.covis,
                                             neighbors.clamp(min=0)), 0),
                        dim=1)
        first = mask_from_ids(neighbors, nb_ok, K_, seq=True) | \
            (torch.arange(K_, device=dev) == kf_id[:, None])
        w2 = torch.where(state.kf_valid & ~first, w2, 0)
        top2_w, top2_i = stable_topk(w2, n2)
        neighbors = torch.cat([neighbors, torch.where(top2_w >= 15, top2_i,
                                                      -1)], 1)
    bounds = (0.0, float(cfg.camera.width), 0.0, float(cfg.camera.height))

    def match_points_into(state, pw, desc, min_d, max_d, normal, pt_ok, dst):
        """Project each sequence's point set [S, P] into its keyframe
        dst [S] with the Fuse gates; returns (kp index per point or -1,
        matched mask)."""
        T = seq_take(state.kf_pose, dst)[:, None]
        pc = lie.se3_apply(T, pw)
        uv = camera.project(K, pc)
        rel = pw + lie.quat_rotate(lie.quat_conj(T[..., :4]), T[..., 4:7])
        d = torch.linalg.vector_norm(rel, dim=-1)
        band = (d >= 0.8 * min_d) & (d <= 1.2 * max_d)
        vcos = torch.sum(rel * normal, -1) / torch.clamp(d, min=1e-9)
        ok = pt_ok & (pc[..., 2] > 0) & camera.in_image(uv, bounds) & \
            band & (vcos > 0.5)
        pred = predict_scale(d, max_d, sf, cfg.orb.n_levels)
        radius = radius_base * sf ** pred.to(torch.float32)
        kf_uv = seq_take(state.kf_uv, dst)
        kf_oct = seq_take(state.kf_octave, dst)
        dist = hamming.hamming_matrix(desc, seq_take(state.kf_desc, dst))
        gate = search.window_gate(uv, kf_uv, radius)
        gate = gate & search.octave_gate(pred, kf_oct, -1, 1)
        res = search.match_descriptors(dist, gate, cfg.match.th_low, None,
                                       ok, seq_take(state.kf_kp_valid, dst))
        matched = res.idx >= 0
        kp = res.idx.clamp(min=0)
        err = torch.sum((kf_uv.gather(1, kp[..., None].expand(
            kp.shape + (2,))) - uv) ** 2, -1)
        sig2 = (sf ** kf_oct.gather(1, kp).to(torch.float32)) ** 2
        matched = matched & (err / sig2 < 5.99)
        return torch.where(matched, kp, -1), matched

    # ---- direction A: the new KF's points into every target, applied in
    # one batched pass from one map snapshot ----
    pids0 = seq_take(state.kf_obs, kf_id)                      # [S, N]
    safe0 = pids0.long().clamp(min=0)
    ok0 = (pids0 >= 0) & seq_take(state.mp_valid, safe0)
    nb_safe = neighbors.clamp(min=0)
    T_ = neighbors.shape[1]
    pts0 = [seq_take(t, safe0) for t in (
        state.mp_pos, state.mp_desc, state.mp_min_dist, state.mp_max_dist,
        state.mp_normal)]
    kp_a, m_a = [], []
    for t in range(T_):     # every slot; a -1 slot matches nothing
        kp, m = match_points_into(state, *pts0, ok0, nb_safe[:, t])
        m = m & (neighbors[:, t:t + 1] >= 0)
        kp_a.append(torch.where(m, kp, -1))
        m_a.append(m)
    kp_a, m_a = torch.stack(kp_a, 1), torch.stack(m_a, 1)
    state = _apply_fuse_onepass(state, nb_safe, neighbors >= 0, kp_a, m_a,
                                pids0)

    # ---- direction B: the union of the targets' points into the new KF ----
    tobs = seq_take(state.kf_obs, nb_safe)                     # [S, T, N]
    tmask = mask_from_ids(tobs, (neighbors >= 0)[..., None] & (tobs >= 0), M,
                          seq=True) & state.mp_valid
    own = mask_from_ids(pids0, pids0 >= 0, M, seq=True)
    cand = tmask & ~own
    P = min(2048, M)
    sel = first_flagged(cand, P)                               # [S, P]
    sel_ok = cand.gather(1, sel)
    kp_b, m_b = match_points_into(
        state, *(seq_take(t, sel) for t in (
            state.mp_pos, state.mp_desc, state.mp_min_dist,
            state.mp_max_dist, state.mp_normal)), sel_ok, kf_id)
    # two candidates matching one keypoint: the later claim stands
    m_b = last_writer(kp_b, m_b, N)
    src_pid = torch.where(m_b, sel, -1)

    cnt = point_obs_count(state)
    kpb = kp_b.clamp(min=0)
    existing = seq_take(state.kf_obs, kf_id).gather(1, kpb).long()
    ex_safe = existing.clamp(min=0)
    add_case = m_b & (existing < 0) & (src_pid >= 0)
    merge_case = m_b & (existing >= 0) & (existing != src_pid) & \
        (src_pid >= 0) & seq_take(state.mp_valid, ex_safe)
    src_bigger = seq_take(cnt, src_pid.clamp(min=0)) >= seq_take(cnt, ex_safe)
    loser = torch.where(src_bigger, existing, src_pid)
    winner = torch.where(src_bigger, src_pid, existing)
    state = ops.add_obs(state, kf_id, kpb, torch.where(add_case, src_pid, -1))
    lsafe = torch.where(merge_case, loser, M)
    ar = seq_index(lsafe)
    src_arr = torch.full((S, M + 1), -1, dtype=torch.int64, device=dev)
    dst_arr = torch.full((S, M + 1), -1, dtype=torch.int64, device=dev)
    src_arr[ar, lsafe] = torch.where(merge_case, loser, -1)
    dst_arr[ar, lsafe] = torch.where(merge_case, winner, -1)
    src_arr, dst_arr = src_arr[:, :M], dst_arr[:, :M]
    src_arr = torch.where(src_arr == torch.arange(M, device=dev), src_arr, -1)
    state = ops.replace_points(state, src_arr, dst_arr)

    # refresh attributes of the points observed by the new KF and targets
    # (invalid target slots read keyframe 0, as in the JAX version)
    kfs = torch.cat([kf_id[:, None], nb_safe], 1)
    touched = seq_take(state.kf_obs, kfs)
    tmask = mask_from_ids(touched, touched >= 0, M, seq=True)
    state = ops.update_point_attributes(
        state, tmask & state.mp_valid, cfg.orb.scale_factor, cfg.orb.n_levels)
    return update_covisibility_for_kf(state, kf_id)
