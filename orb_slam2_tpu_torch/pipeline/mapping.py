"""Local mapping at keyframe rate: new-point triangulation, point fusion,
point and keyframe culling (port of orb_slam2_tpu/pipeline/mapping.py, the
monocular subset; reference LocalMapping.cc run deterministically after a
keyframe insertion).

Where the JAX code `vmap`s over neighbour keyframes, this port loops over
them on the host; neighbour slots that are -1 (fewer covisible keyframes
than asked for) produce no candidates in the JAX version and are skipped.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import (MapState, covisible_neighbors,
                                           first_flagged, last_writer,
                                           mask_from_ids, point_obs_count,
                                           stable_topk,
                                           update_covisibility_for_kf,
                                           weighted_obs_count)
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline.init import pids_mask_from
from orb_slam2_tpu_torch.pipeline.tracking import predict_scale
from orb_slam2_tpu_torch.solvers import triangulate as tri


def _camera_center(T):
    return -lie.quat_rotate(lie.quat_conj(lie.se3_q(T)), lie.se3_t(T))


def _fundamental(T1, T2, K):
    """F such that x2^T F x1 = 0 for pixel coords, from the poses of views
    1 and 2 (reference LocalMapping::ComputeF12)."""
    T12 = lie.se3_compose(T1, lie.se3_inverse(T2))
    R = lie.quat_to_matrix(lie.se3_q(T12))
    E = lie.hat(lie.se3_t(T12)) @ R
    one, zero = torch.ones((), device=K.device), torch.zeros((), device=K.device)
    Kinv = torch.stack([torch.stack([1.0 / K[0], zero, -K[2] / K[0]]),
                        torch.stack([zero, 1.0 / K[1], -K[3] / K[1]]),
                        torch.stack([zero, zero, one])])
    return Kinv.T @ E @ Kinv


def median_scene_depth(state: MapState, k, K) -> torch.Tensor:
    """Median depth of the points keyframe k observes."""
    obs = state.kf_obs[k]
    has = obs >= 0
    pw = state.mp_pos[obs.long().clamp(min=0)]
    z = lie.se3_apply(state.kf_pose[k], pw)[:, 2]
    n = torch.clamp(torch.sum(has.to(torch.int32)), min=1)
    z_sorted = torch.sort(torch.where(has, z, float("inf")))[0]
    return z_sorted[torch.clamp((n - 1) // 2, 0, z.shape[0] - 1)]


def _valid_ids(ids: torch.Tensor):
    """Host list of the non-negative entries of a small id tensor."""
    return [int(v) for v in ids.tolist() if v >= 0]


def triangulate_new_points(state: MapState, kf_id: int, cfg: SLAMConfig,
                           n_neighbors: int | None = None) -> MapState:
    """Create map points by triangulating the new keyframe's unmatched
    keypoints against its best covisible neighbours (reference
    LocalMapping::CreateNewMapPoints); per keypoint the valid candidate with
    the largest parallax wins."""
    dev = state.kf_pose.device
    K = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    N = state.kf_obs.shape[1]
    if n_neighbors is None:
        n_neighbors = cfg.mapping.triangulate_neighbors
    neighbors = covisible_neighbors(state, kf_id, n_neighbors, min_weight=15)
    T1 = state.kf_pose[kf_id]
    c1 = _camera_center(T1)
    med_depth = median_scene_depth(state, kf_id, K)
    kp1_free = state.kf_kp_valid[kf_id] & (state.kf_obs[kf_id] < 0)
    desc1 = state.kf_desc[kf_id]
    uv1 = state.kf_uv[kf_id]
    oct1 = state.kf_octave[kf_id]
    ang1 = state.kf_angle[kf_id]
    sigma1 = sf ** oct1.to(torch.float32)
    ones = torch.ones((N, 1), device=dev)
    ph1 = torch.cat([uv1, ones], -1)
    xn1 = (uv1 - K[2:4]) / K[:2]

    def per_neighbor(nb: int):
        T2 = state.kf_pose[nb]
        c2 = _camera_center(T2)
        baseline = torch.linalg.vector_norm(c2 - c1)
        base_ok = baseline / torch.clamp(med_depth, min=1e-9) > 0.01
        kp2_free = state.kf_kp_valid[nb] & (state.kf_obs[nb] < 0)
        uv2 = state.kf_uv[nb]
        oct2 = state.kf_octave[nb]
        F = _fundamental(T2, T1, K)
        ph2 = torch.cat([uv2, ones], -1)
        l2 = ph1 @ F.T
        num = (l2[:, None, :] * ph2[None, :, :]).sum(-1) ** 2
        den = torch.clamp(l2[:, 0:1] ** 2 + l2[:, 1:2] ** 2, min=1e-12)
        sigma2_2 = (sf ** oct2.to(torch.float32)) ** 2
        gate = num / den < 3.84 * sigma2_2[None, :]
        e2 = camera.project(K, lie.se3_apply(T2, c1)[None])[0]
        far = torch.sum((uv2 - e2) ** 2, -1) > 100.0 * sigma2_2
        gate = gate & far[None, :]
        dist = hamming.hamming_matrix(desc1, state.kf_desc[nb])
        res = search.match_descriptors(dist, gate, cfg.match.th_low, None,
                                       kp1_free, kp2_free)
        idx = search.rotation_consistency(ang1, state.kf_angle[nb], res.idx,
                                          cfg.match.histo_length)
        m = idx >= 0
        idx_s = idx.clamp(min=0)
        xn2 = (uv2[idx_s] - K[2:4]) / K[:2]
        pw = tri.triangulate_dlt(T1[None], T2[None], xn1, xn2)
        z1 = tri.depth_in(T1, pw)
        z2 = tri.depth_in(T2, pw)
        cosp = tri.parallax_cos(c1, c2, pw)
        chi1 = tri.reprojection_error(T1, K, pw, uv1) / torch.clamp(
            sigma1 ** 2, min=1e-9)
        chi2 = tri.reprojection_error(T2, K, pw, uv2[idx_s]) / \
            sigma2_2[idx_s]
        d1 = torch.linalg.vector_norm(pw - c1, dim=-1)
        d2 = torch.linalg.vector_norm(pw - c2, dim=-1)
        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        ratio_oct = sf ** (oct1 - oct2[idx_s]).to(torch.float32)
        ratio_factor = 1.5 * sf
        scale_ok = (ratio_dist > ratio_oct / ratio_factor) & \
                   (ratio_dist < ratio_oct * ratio_factor)
        good = (m & base_ok & torch.all(torch.isfinite(pw), -1) &
                (cosp < 0.9998) & (cosp > 0) & (z1 > 0) & (z2 > 0) &
                (chi1 < cfg.mapping.epipolar_chi2_mono) &
                (chi2 < cfg.mapping.epipolar_chi2_mono) & scale_ok)
        return good, pw, idx, cosp

    nbs = _valid_ids(neighbors)
    if nbs:
        goods, pws, idxs, cosps = (torch.stack(a) for a in zip(
            *[per_neighbor(nb) for nb in nbs]))
        score = torch.where(goods, 1.0 - cosps, -1.0)      # [NB, N]
        best_nb = torch.argmax(score, dim=0)
        ar = torch.arange(N, device=dev)
        any_good = torch.any(goods, dim=0)
        pw_best = pws[best_nb, ar]
        idx_best = idxs[best_nb, ar]
        nb_best = torch.as_tensor(nbs, device=dev)[best_nb]
    else:
        any_good = torch.zeros(N, dtype=torch.bool, device=dev)
        pw_best = torch.zeros((N, 3), device=dev)
        idx_best = torch.zeros(N, dtype=torch.int64, device=dev)
        nb_best = idx_best

    state, pids = ops.alloc_points(state, any_good, pw_best,
                                   state.kf_desc[kf_id], kf_id)
    state = ops.add_obs(state, kf_id, torch.arange(N, device=dev), pids)
    state = ops.add_obs_multi(state, torch.where(pids >= 0, nb_best, -1),
                              idx_best.clamp(min=0), pids)
    state = ops.update_point_attributes(
        state, pids_mask_from(pids, state.mp_pos.shape[0]),
        cfg.orb.scale_factor, cfg.orb.n_levels)
    return update_covisibility_for_kf(state, kf_id)


def cull_points(state: MapState, kf_id: int, cfg: SLAMConfig) -> MapState:
    """Recent-point culling (reference LocalMapping::MapPointCulling): found
    ratio < 0.25, or too few observations two keyframes after creation;
    points of the two bootstrap keyframes are exempt."""
    cnt = point_obs_count(state)
    found_ratio = state.mp_found.to(torch.float32) / \
        torch.clamp(state.mp_visible, min=1).to(torch.float32)
    age = kf_id - state.mp_first_kf
    min_obs = 2 if cfg.sensor == 0 else cfg.mapping.cull_min_obs
    bad = state.mp_valid & (
        (found_ratio < cfg.mapping.found_ratio_min) |
        ((age >= 2) & (cnt <= min_obs)))
    bad = bad & (age <= 3) & (state.mp_first_kf >= 2)
    return ops.cull_points(state, bad)


def cull_keyframe(state: MapState, ts, c: int, cfg: SLAMConfig):
    """Invalidate keyframe c (reference KeyFrame::SetBadFlag): erase its
    observations (discarding points left with nObs <= 2), re-parent its
    children by max covisibility, store the relative pose, and retarget the
    trajectory records that referenced it to its parent.  Returns
    (state, ts)."""
    K = state.kf_valid.shape[0]
    M = state.mp_pos.shape[0]
    dev = state.kf_pose.device
    parent = state.kf_parent[c]
    parent = torch.where(parent >= 0, parent, 0).to(torch.int32)
    rel_cp = lie.se3_compose(state.kf_pose[c],
                             lie.se3_inverse(state.kf_pose[parent.long()]))
    pids = state.kf_obs[c]
    touched = mask_from_ids(pids, pids >= 0, M)
    state = ops.remove_obs(state, c, torch.ones(state.kf_obs.shape[1],
                                                dtype=torch.bool, device=dev))
    w_cnt = weighted_obs_count(state)
    state = ops.cull_points(state, touched & state.mp_valid & (w_cnt <= 2))
    kf_valid = state.kf_valid.clone()
    kf_valid[c] = False
    covis = state.covis.clone()
    covis[c, :] = 0
    covis[:, c] = 0
    kf_bow = state.kf_bow.clone()
    kf_bow[c] = 0.0
    kf_pose_rel = state.kf_pose_rel.clone()
    kf_pose_rel[c] = rel_cp
    state = state._replace(kf_valid=kf_valid, covis=covis, kf_bow=kf_bow,
                           kf_pose_rel=kf_pose_rel)
    ids = torch.arange(K, device=dev)
    children = state.kf_parent == c
    w = torch.where(state.kf_valid[None, :] & (ids[None, :] < ids[:, None]),
                    state.covis, -1)
    best = torch.argmax(w, dim=1).to(torch.int32)
    new_par = torch.where(torch.amax(w, dim=1) > 0, best, parent)
    state = state._replace(
        kf_parent=torch.where(children, new_par, state.kf_parent))
    hit = ts.traj[:, 14].to(torch.int32) == c
    rel2 = lie.se3_compose(ts.traj[:, 7:14], rel_cp)
    traj = ts.traj.clone()
    traj[:, 7:14] = torch.where(hit[:, None], rel2, ts.traj[:, 7:14])
    traj[:, 14] = torch.where(hit, parent.to(torch.float32), traj[:, 14])
    return state, ts._replace(traj=traj)


def cull_redundant_keyframes(state: MapState, ts, kf_id: int,
                             cfg: SLAMConfig, n_candidates: int = 10):
    """Reference LocalMapping::KeyFrameCulling: a covisible keyframe is
    redundant if >90% of its points are seen by >= 3 other keyframes at the
    same or finer scale; the most redundant one is culled.  Returns
    (state, ts)."""
    th_obs = cfg.mapping.kf_cull_th_obs
    cands = covisible_neighbors(state, kf_id, n_candidates, min_weight=15)
    csafe = cands.clamp(min=0)
    pids = state.kf_obs[csafe]                               # [C, N]
    valid = pids >= 0
    safe = pids.long().clamp(min=0)
    okf = state.mp_obs_kf[safe].long()                       # [C, N, D]
    okp = state.mp_obs_kp[safe].long()
    o_ok = okf >= 0
    kfs, kps = okf.clamp(min=0), okp.clamp(min=0)
    obs_oct = state.kf_octave[kfs, kps]
    wgt = torch.where(state.kf_ur[kfs, kps] >= 0, 2, 1)
    tot_w = torch.sum(torch.where(o_ok, wgt, 0), dim=2)
    scale = state.kf_octave[csafe]
    fine = o_ok & (okf != csafe[:, None, None]) & \
        (obs_oct <= scale[..., None] + 1)
    n_fine = torch.sum(fine.to(torch.int32), dim=2)
    red = valid & (tot_w > th_obs) & (n_fine >= th_obs)
    nmp = torch.sum(valid.to(torch.int32), dim=1)
    nred = torch.sum(red.to(torch.int32), dim=1)
    ratio = nred / torch.clamp(nmp, min=1).to(torch.float32)
    culls = ((cands > 0) & (cands != kf_id) & (nmp > 0) &
             (nred > cfg.mapping.kf_cull_redundancy * nmp))
    bi = torch.argmax(torch.where(culls, ratio, -1.0))
    c = int(torch.where(culls[bi], cands[bi], -1))
    if c >= 0:
        state, ts = cull_keyframe(state, ts, c, cfg)
    return state, ts


def _apply_fuse_onepass(state: MapState, tgt_kf, tgt_ok, kp_a, m_a,
                        pids0) -> MapState:
    """Direction-A fuse bookkeeping for all targets in one batched pass
    (ORBmatcher::Fuse add/merge semantics).  tgt_kf [T] target keyframes,
    tgt_ok [T], kp_a/m_a [T, N] matched keypoint per source row, pids0 [N]
    the new KF's point per row.  The lowest proposal index wins a contested
    target keypoint, one merge per loser, and a point that loses anywhere
    in the pass neither adds nor wins."""
    K_, N = state.kf_obs.shape
    M, D = state.mp_obs_kf.shape
    T = tgt_kf.shape[0]
    KN = K_ * N
    dev = tgt_kf.device

    cnt = point_obs_count(state)
    kp = kp_a.clamp(min=0)
    src_pid = torch.where(m_a & tgt_ok[:, None], pids0.long().expand(T, N), -1)
    psafe = src_pid.clamp(min=0)
    src_ok = (src_pid >= 0) & state.mp_valid[psafe]
    existing = state.kf_obs[tgt_kf[:, None], kp].long()
    ex_safe = existing.clamp(min=0)
    add_case = src_ok & (existing < 0)
    merge_case = src_ok & (existing >= 0) & (existing != src_pid) & \
        state.mp_valid[ex_safe]

    prop = (torch.arange(T, device=dev)[:, None] * N +
            torch.arange(N, device=dev)[None, :])
    key = tgt_kf[:, None] * N + kp
    any_case = add_case | merge_case
    claim = torch.full((KN + 1,), T * N, dtype=torch.int64, device=dev
                       ).scatter_reduce(0, torch.where(any_case, key, KN)
                                        .reshape(-1), prop.reshape(-1),
                                        "amin")[:KN]
    keep = any_case & (claim[key] == prop)
    add_case = add_case & keep
    merge_case = merge_case & keep

    src_bigger = cnt[psafe] >= cnt[ex_safe]
    loser = torch.where(src_bigger, existing, src_pid)
    winner = torch.where(src_bigger, src_pid, existing)
    lsafe = loser.clamp(min=0)
    lclaim = torch.full((M + 1,), T * N, dtype=torch.int64, device=dev
                        ).scatter_reduce(0, torch.where(merge_case, lsafe, M)
                                         .reshape(-1), prop.reshape(-1),
                                         "amin")[:M]
    mkeep = merge_case & (lclaim[lsafe] == prop)
    loser_set = mask_from_ids(lsafe, mkeep, M)
    mkeep = mkeep & ~loser_set[winner.clamp(min=0)]
    loser_set = mask_from_ids(lsafe, mkeep, M)
    ltgt = torch.where(mkeep, lsafe, M).reshape(-1)
    src_arr = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    dst_arr = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    src_arr[ltgt] = torch.where(mkeep, loser, -1).reshape(-1)
    dst_arr[ltgt] = torch.where(mkeep, winner, -1).reshape(-1)
    src_arr, dst_arr = src_arr[:M], dst_arr[:M]
    src_arr = torch.where(src_arr == torch.arange(M, device=dev), src_arr, -1)

    # adds: a losing point does not add; write kf_obs + ranked mirror slots
    add_case = add_case & ~loser_set[psafe]
    kf_obs = torch.cat([state.kf_obs.reshape(-1),
                        torch.full((1,), -1, dtype=torch.int32, device=dev)])
    kf_obs[torch.where(add_case, key, KN)] = \
        torch.where(add_case, src_pid, -1).to(torch.int32)
    rank = torch.cumsum(add_case.to(torch.int64), dim=0) - 1
    free = state.mp_obs_kf < 0
    free_order = torch.argsort((~free).to(torch.int8), dim=1, stable=True)
    n_free = torch.sum(free.to(torch.int64), dim=1)
    slot = free_order[psafe, rank.clamp(0, D - 1)]
    can = add_case & (rank < n_free[psafe])
    # a point listed at two source rows claims one slot twice; the later
    # write stands, as on the reference's CPU backend
    can = last_writer((psafe * D + slot).reshape(-1), can.reshape(-1),
                      M * D).reshape(T, N)
    pr = torch.where(can, psafe, M)
    obs_kf = torch.cat([state.mp_obs_kf, torch.full((1, D), -1,
                                                    dtype=torch.int32,
                                                    device=dev)])
    obs_kp = torch.cat([state.mp_obs_kp, torch.full((1, D), -1,
                                                    dtype=torch.int32,
                                                    device=dev)])
    obs_kf[pr, slot] = torch.where(can, tgt_kf[:, None].expand(T, N),
                                   -1).to(torch.int32)
    obs_kp[pr, slot] = torch.where(
        can, torch.arange(N, device=dev)[None, :].expand(T, N),
        -1).to(torch.int32)
    state = state._replace(kf_obs=kf_obs[:KN].reshape(K_, N),
                           mp_obs_kf=obs_kf[:M], mp_obs_kp=obs_kp[:M])
    return ops.replace_points(state, src_arr, dst_arr)


def fuse_neighbors(state: MapState, kf_id: int, cfg: SLAMConfig,
                   n_neighbors: int | None = None) -> MapState:
    """Two-way map-point fusion with covisible neighbours (reference
    LocalMapping::SearchInNeighbors + ORBmatcher::Fuse).  Direction A
    projects the new KF's points into every target, direction B the
    targets' points into the new KF; matched free keypoints gain the
    observation, occupied ones merge towards the point with more
    observations.  Descriptors/normals and the covisibility row are then
    refreshed."""
    dev = state.kf_pose.device
    K = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    N = state.kf_obs.shape[1]
    M = state.mp_pos.shape[0]
    K_ = state.covis.shape[0]
    radius_base = cfg.mapping.fuse_radius
    if n_neighbors is None:
        n_neighbors = cfg.mapping.fuse_neighbors

    neighbors = covisible_neighbors(state, kf_id, n_neighbors, min_weight=15)
    n2 = cfg.mapping.fuse_neighbors_second
    if n2 > 0:
        nb_ok = neighbors >= 0
        w2 = torch.amax(torch.where(nb_ok[:, None],
                                    state.covis[neighbors.clamp(min=0)], 0),
                        dim=0)
        first = mask_from_ids(neighbors, nb_ok, K_)
        first[kf_id] = True
        w2 = torch.where(state.kf_valid & ~first, w2, 0)
        top2_w, top2_i = stable_topk(w2, n2)
        neighbors = torch.cat([neighbors, torch.where(top2_w >= 15, top2_i,
                                                      -1)])
    bounds = (0.0, float(cfg.camera.width), 0.0, float(cfg.camera.height))

    def match_points_into(state, pw, desc, min_d, max_d, normal, pt_ok, dst):
        """Project a point set into keyframe `dst` with the Fuse gates;
        returns (kp index per point or -1, matched mask)."""
        T = state.kf_pose[dst]
        pc = lie.se3_apply(T, pw)
        uv = camera.project(K, pc)
        rel = pw + lie.quat_rotate(lie.quat_conj(T[:4]), T[4:7])
        d = torch.linalg.vector_norm(rel, dim=-1)
        band = (d >= 0.8 * min_d) & (d <= 1.2 * max_d)
        vcos = torch.sum(rel * normal, -1) / torch.clamp(d, min=1e-9)
        ok = pt_ok & (pc[:, 2] > 0) & camera.in_image(uv, bounds) & \
            band & (vcos > 0.5)
        pred = predict_scale(d, max_d, sf, cfg.orb.n_levels)
        radius = radius_base * sf ** pred.to(torch.float32)
        dist = hamming.hamming_matrix(desc, state.kf_desc[dst])
        gate = search.window_gate(uv, state.kf_uv[dst], radius)
        gate = gate & search.octave_gate(pred, state.kf_octave[dst], -1, 1)
        res = search.match_descriptors(dist, gate, cfg.match.th_low, None,
                                       ok, state.kf_kp_valid[dst])
        matched = res.idx >= 0
        kp = res.idx.clamp(min=0)
        err = torch.sum((state.kf_uv[dst][kp] - uv) ** 2, -1)
        sig2 = (sf ** state.kf_octave[dst][kp].to(torch.float32)) ** 2
        matched = matched & (err / sig2 < 5.99)
        return torch.where(matched, kp, -1), matched

    # ---- direction A: the new KF's points into every target, applied in
    # one batched pass from one map snapshot ----
    pids0 = state.kf_obs[kf_id]
    safe0 = pids0.long().clamp(min=0)
    ok0 = (pids0 >= 0) & state.mp_valid[safe0]
    nb_safe = neighbors.clamp(min=0)
    T_ = neighbors.shape[0]
    kp_a = torch.full((T_, N), -1, dtype=torch.int64, device=dev)
    m_a = torch.zeros((T_, N), dtype=torch.bool, device=dev)
    for t, nb in enumerate(neighbors.tolist()):
        if nb >= 0:
            kp_a[t], m_a[t] = match_points_into(
                state, state.mp_pos[safe0], state.mp_desc[safe0],
                state.mp_min_dist[safe0], state.mp_max_dist[safe0],
                state.mp_normal[safe0], ok0, nb)
    state = _apply_fuse_onepass(state, nb_safe, neighbors >= 0, kp_a, m_a,
                                pids0)

    # ---- direction B: the union of the targets' points into the new KF ----
    tobs = state.kf_obs[nb_safe]
    tmask = mask_from_ids(tobs, (neighbors >= 0)[:, None] & (tobs >= 0), M) \
        & state.mp_valid
    own = mask_from_ids(pids0, pids0 >= 0, M)
    cand = tmask & ~own
    P = min(2048, M)
    sel = first_flagged(cand, P)
    sel_ok = cand[sel]
    kp_b, m_b = match_points_into(
        state, state.mp_pos[sel], state.mp_desc[sel], state.mp_min_dist[sel],
        state.mp_max_dist[sel], state.mp_normal[sel], sel_ok, kf_id)
    # two candidates matching one keypoint: the later claim stands
    m_b = last_writer(kp_b, m_b, N)
    src_pid = torch.where(m_b, sel, -1)

    cnt = point_obs_count(state)
    kpb = kp_b.clamp(min=0)
    existing = state.kf_obs[kf_id][kpb].long()
    ex_safe = existing.clamp(min=0)
    add_case = m_b & (existing < 0) & (src_pid >= 0)
    merge_case = m_b & (existing >= 0) & (existing != src_pid) & \
        (src_pid >= 0) & state.mp_valid[ex_safe]
    src_bigger = cnt[src_pid.clamp(min=0)] >= cnt[ex_safe]
    loser = torch.where(src_bigger, existing, src_pid)
    winner = torch.where(src_bigger, src_pid, existing)
    state = ops.add_obs(state, kf_id, kpb, torch.where(add_case, src_pid, -1))
    lsafe = torch.where(merge_case, loser, M)
    src_arr = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    dst_arr = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    src_arr[lsafe] = torch.where(merge_case, loser, -1)
    dst_arr[lsafe] = torch.where(merge_case, winner, -1)
    src_arr, dst_arr = src_arr[:M], dst_arr[:M]
    src_arr = torch.where(src_arr == torch.arange(M, device=dev), src_arr, -1)
    state = ops.replace_points(state, src_arr, dst_arr)

    # refresh attributes of the points observed by the new KF and targets
    # (invalid target slots read keyframe 0, as in the JAX version)
    kfs = torch.cat([torch.as_tensor([kf_id], device=dev), nb_safe])
    touched = state.kf_obs[kfs]
    tmask = mask_from_ids(touched, touched >= 0, M)
    state = ops.update_point_attributes(
        state, tmask & state.mp_valid, cfg.orb.scale_factor, cfg.orb.n_levels)
    return update_covisibility_for_kf(state, kf_id)
