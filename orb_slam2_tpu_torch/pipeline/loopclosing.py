"""Loop closing: detection, Sim3 verification, correction and the pose
graph (port of orb_slam2_tpu/pipeline/loopclosing.py; reference
LoopClosing.cc, run deterministically at keyframe rate, not on a thread).

`detect` returns candidate ids and their covisibility groups; the small
temporal-consistency state machine (3 consecutive hits, LoopClosing.cc:
152-211) runs on the host over those few ints; `verify` and `correct` are
tensor code.  Where JAX scatters with `.at[].set` and a target can repeat,
`map/state.set_last` writes only the last row for each target: JAX's
result on the CPU, and the same result every run on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_tpu_torch.ba import posegraph
from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import (MapState, covisible_neighbors,
                                           first_flagged, mask_from_ids,
                                           set_last, stable_topk,
                                           update_covisibility_for_kf)
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline.tracking import predict_scale
from orb_slam2_tpu_torch.place import database
from orb_slam2_tpu_torch.place.vocab import table_scores
from orb_slam2_tpu_torch.solvers import sim3 as sim3_mod
from orb_slam2_tpu_torch.solvers.twoview import sets_from_uniform

SIM3_ITERS = 128


def _bounds(cfg: SLAMConfig):
    return (0.0, float(cfg.camera.width), 0.0, float(cfg.camera.height))


# ---------------------------------------------------------------------------
# detection + host consistency tracking
# ---------------------------------------------------------------------------

def detect(state: MapState, kf_id, cfg: SLAMConfig, n_cand: int = 8):
    """Loop candidates for the new keyframe (reference LoopClosing::DetectLoop,
    LoopClosing.cc:103-229).  Returns (cand_ids [C], cand_groups [C, K]
    bool covisibility groups)."""
    # minScore: lowest BoW similarity among covisible neighbours
    nb = covisible_neighbors(state, kf_id, 30, min_weight=15)
    scores, _ = table_scores(state.kf_bow[kf_id], state.kf_bow, nb)
    min_score = torch.amin(torch.where(nb >= 0, scores, 1.0))
    res = database.detect_loop_candidates(
        state.kf_bow, state.kf_valid, state.covis, kf_id,
        state.kf_bow[kf_id], min_score, n_out=n_cand,
        shared_frac=cfg.loop.shared_word_frac,
        acc_frac=cfg.loop.acc_score_frac)
    cs = res.ids.long().clamp(min=0)
    # candidate group = candidate + its connected KFs (weight >= 15,
    # GetConnectedKeyFrames)
    K = state.covis.shape[0]
    groups = (state.covis[cs] >= 15) | \
        (cs[:, None] == torch.arange(K, device=cs.device))
    return res.ids, groups & (res.ids >= 0)[:, None]


class ConsistencyTracker:
    """Host-side temporal consistency over candidate groups (reference
    mvConsistentGroups, LoopClosing.cc:152-211)."""

    def __init__(self, th: int = 3):
        self.th = th
        self.prev: list[tuple[set, int]] = []

    def update(self, cand_ids: np.ndarray, groups: np.ndarray) -> list[int]:
        """Candidate keyframe ids that reached the consistency threshold."""
        current = []
        enough = []
        for c, grp in zip(cand_ids, groups):
            if c < 0:
                continue
            gset = set(np.nonzero(grp)[0].tolist())
            best = 0
            for pset, cnt in self.prev:
                if gset & pset:
                    best = max(best, cnt + 1)
            current.append((gset, best))
            if best >= self.th:
                enough.append(int(c))
        self.prev = current
        return enough

    def reset(self):
        self.prev = []


# ---------------------------------------------------------------------------
# Sim3 verification
# ---------------------------------------------------------------------------

def _loop_points(state: MapState, cand_id) -> torch.Tensor:
    """[M] points observed by the candidate or its top-10 connected
    keyframes (the loop neighbourhood)."""
    M = state.mp_pos.shape[0]
    nb2 = torch.cat([torch.as_tensor(cand_id, device=state.kf_obs.device
                                     ).reshape(1).long(),
                     covisible_neighbors(state, cand_id, 10, min_weight=15)])
    obs = state.kf_obs[nb2.clamp(min=0)]
    return mask_from_ids(obs, (nb2 >= 0)[:, None] & (obs >= 0), M) & \
        state.mp_valid


def verify(state: MapState, kf_id, cand_id, u: torch.Tensor,
           cfg: SLAMConfig):
    """Relative Sim3 between the new keyframe and a loop candidate
    (reference LoopClosing::ComputeSim3, LoopClosing.cc:231-400).

    u: [SIM3_ITERS, 3] uniform draws in [0, 1) from which the Sim3 RANSAC
    samples are taken among the matched keypoints
    (`twoview.sets_from_uniform`).  Returns (ok, Scm [8]
    corrected Sim3 world->current, loop point id per current keypoint [N],
    stats [3] = (BoW matches, Sim3 inliers, total matches))."""
    dev = state.kf_pose.device
    K = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    N = state.kf_obs.shape[1]
    M = state.mp_pos.shape[0]
    fix_scale = cfg.sensor != 0
    bounds = _bounds(cfg)
    # match-count gates scaled with the extraction budget (floor at half)
    fscale = max(0.5, min(1.0, cfg.orb.n_features / 1000.0))
    min_bow = max(5, int(round(cfg.loop.min_bow_matches * fscale)))
    min_inl_gate = max(5, int(round(cfg.loop.min_sim3_inliers * fscale)))
    min_total = max(10, int(round(cfg.loop.min_total_matches * fscale)))

    # 1. descriptor matches between the two keyframes' tracked points
    pids1 = state.kf_obs[kf_id]
    pids2 = state.kf_obs[cand_id]
    p1s, p2s = pids1.long().clamp(min=0), pids2.long().clamp(min=0)
    ok1 = (pids1 >= 0) & state.mp_valid[p1s]
    ok2 = (pids2 >= 0) & state.mp_valid[p2s]
    dist = hamming.hamming_matrix(state.kf_desc[kf_id], state.kf_desc[cand_id])
    res = search.match_descriptors(
        dist, torch.ones_like(dist, dtype=torch.bool), cfg.match.th_loop,
        cfg.match.nn_ratio_sim3, ok1, ok2)
    idx = search.rotation_consistency(state.kf_angle[kf_id],
                                      state.kf_angle[cand_id], res.idx,
                                      cfg.match.histo_length)
    matched = idx >= 0
    n_bow = torch.sum(matched.to(torch.int32))

    idx_s = idx.long().clamp(min=0)
    T1 = state.kf_pose[kf_id]
    T2 = state.kf_pose[cand_id]
    p1 = lie.se3_apply(T1, state.mp_pos[p1s])
    p2 = lie.se3_apply(T2, state.mp_pos[p2s[idx_s]])
    uv1 = state.kf_uv[kf_id]
    uv2 = state.kf_uv[cand_id][idx_s]
    sig1 = (sf ** state.kf_octave[kf_id].to(torch.float32)) ** 2
    sig2 = (sf ** state.kf_octave[cand_id][idx_s].to(torch.float32)) ** 2

    # 2. RANSAC Horn
    rr = sim3_mod.sim3_ransac(
        sets_from_uniform(u, matched), p1, p2, uv1, uv2, matched, K,
        cfg.loop.sim3_chi2 * sig1, cfg.loop.sim3_chi2 * sig2,
        fix_scale=fix_scale, min_inliers=min_inl_gate)

    # 2b. SearchBySim3 two-way guided top-up (ORBmatcher.cc:1102-1326):
    # pairs found by projecting both ways, excluding BoW-matched points
    cand_used = mask_from_ids(idx_s, matched, N)
    p2_all = lie.se3_apply(T2, state.mp_pos[p2s])
    pc1 = lie.sim3_apply(rr.S12, p2_all)                 # cand pts -> cam1
    uvp1 = camera.project(K, pc1)
    oct_p1 = predict_scale(torch.linalg.vector_norm(pc1, dim=-1),
                           state.mp_max_dist[p2s], sf, cfg.orb.n_levels)
    vis1 = ok2 & ~cand_used & (pc1[:, 2] > 0) & camera.in_image(uvp1, bounds)
    m1 = search.search_by_projection(
        uvp1, oct_p1, state.mp_desc[p2s], vis1,
        state.kf_uv[kf_id], state.kf_octave[kf_id], state.kf_desc[kf_id],
        state.kf_angle[kf_id], state.kf_kp_valid[kf_id],
        cfg.loop.sim3_search_radius * sf ** oct_p1.to(torch.float32),
        max_dist=cfg.match.th_high, ratio=None, oct_lo=-1, oct_hi=0)
    pc2r = lie.sim3_apply(lie.sim3_inverse(rr.S12), p1)  # cur pts -> cam2
    uvp2 = camera.project(K, pc2r)
    oct_p2 = predict_scale(torch.linalg.vector_norm(pc2r, dim=-1),
                           state.mp_max_dist[p1s], sf, cfg.orb.n_levels)
    vis2 = ok1 & ~matched & (pc2r[:, 2] > 0) & camera.in_image(uvp2, bounds)
    m2 = search.search_by_projection(
        uvp2, oct_p2, state.mp_desc[p1s], vis2,
        state.kf_uv[cand_id], state.kf_octave[cand_id],
        state.kf_desc[cand_id], state.kf_angle[cand_id],
        state.kf_kp_valid[cand_id],
        cfg.loop.sim3_search_radius * sf ** oct_p2.to(torch.float32),
        max_dist=cfg.match.th_high, ratio=None, oct_lo=-1, oct_hi=0)
    # two-way agreement (vnMatch1[i1] == i2 && vnMatch2[i2] == i1)
    rev = set_last(N, m1.idx, torch.where(
        m1.idx >= 0, torch.arange(N, dtype=torch.int32, device=dev), -1), -1)
    agree = (rev >= 0) & (m2.idx == rev)
    idx = torch.where(matched, idx, torch.where(agree, m2.idx, -1))
    matched = idx >= 0
    idx_s = idx.long().clamp(min=0)
    p2 = lie.se3_apply(T2, state.mp_pos[p2s[idx_s]])
    uv2 = state.kf_uv[cand_id][idx_s]
    sig2 = (sf ** state.kf_octave[cand_id][idx_s].to(torch.float32)) ** 2

    # 3. LM refinement over the enlarged set
    S12, n_inl, _ = sim3_mod.optimize_sim3(
        rr.S12, p1, p2, uv1, uv2, matched & (rr.inliers | agree), K,
        1.0 / sig1, 1.0 / sig2, fix_scale=fix_scale, th2=10.0, iters=10)

    # 4. project the loop neighbourhood's points into the current keyframe
    # and count the agreement (LoopClosing.cc:333-399); Scm = S12 * T2
    Scm = lie.sim3_compose(S12, lie.sim3_from_se3(T2))
    loop_mask = _loop_points(state, cand_id)
    pc = lie.sim3_apply(Scm, state.mp_pos)
    uvp = camera.project(K, pc)
    vis = loop_mask & (pc[:, 2] > 0) & camera.in_image(uvp, bounds)
    P = min(2048, M)
    # JAX takes argsort(~vis)[:P]: a stable sort puts the flagged points
    # first in index order, as first_flagged does
    sel = first_flagged(vis, P)
    mres = search.search_by_projection(
        uvp[sel], torch.zeros(P, dtype=torch.int32, device=dev),
        state.mp_desc[sel], vis[sel], state.kf_uv[kf_id],
        state.kf_octave[kf_id], state.kf_desc[kf_id], state.kf_angle[kf_id],
        state.kf_kp_valid[kf_id], cfg.loop.search_and_fuse_radius * 2.5,
        max_dist=cfg.match.th_low, ratio=None, oct_lo=-cfg.orb.n_levels,
        oct_hi=cfg.orb.n_levels)
    loop_pids = set_last(N, mres.idx, torch.where(
        mres.idx >= 0, sel.to(torch.int32), -1), -1)
    n_total = torch.sum((loop_pids >= 0).to(torch.int32))

    ok = (n_bow >= min_bow) & rr.ok & (n_inl >= min_inl_gate) & \
        (n_total >= min_total)
    return ok, Scm, loop_pids, torch.stack([n_bow, n_inl, n_total])


# ---------------------------------------------------------------------------
# correction
# ---------------------------------------------------------------------------

def _fuse_into(state: MapState, kf, lp: torch.Tensor) -> MapState:
    """Matched loop points lp [N] replace keyframe kf's conflicting
    observations and claim its free keypoints (LoopClosing.cc:518-535)."""
    M = state.mp_pos.shape[0]
    N = lp.shape[0]
    cur = state.kf_obs[kf]
    both = (lp >= 0) & (cur >= 0) & (cur != lp)
    tgt = torch.where(both, cur.long(), M)     # dummy writes -> void slot M
    src = set_last(M, tgt, torch.where(both, cur, -1), -1)
    dst = set_last(M, tgt, torch.where(both, lp, -1), -1)
    src = torch.where(src == torch.arange(M, device=lp.device), src, -1)
    state = ops.replace_points(state, src, dst)
    add = (lp >= 0) & (state.kf_obs[kf] < 0)
    return ops.add_obs(state, kf, torch.arange(N, device=lp.device),
                       torch.where(add, lp, -1))


def correct(state: MapState, kf_id, cand_id, Scm, loop_pids,
            cfg: SLAMConfig) -> MapState:
    """Loop correction + essential-graph optimization (reference
    LoopClosing::CorrectLoop, LoopClosing.cc:402-585, and
    Optimizer::OptimizeEssentialGraph).  kf_id, cand_id: Python ints."""
    dev = state.kf_pose.device
    K_ = state.kf_pose.shape[0]
    M = state.mp_pos.shape[0]
    S_cur = lie.sim3_from_se3(state.kf_pose[kf_id])

    # the current covisible group takes the correction (LoopClosing.cc:
    # 443-516); JAX writes padding slots (-1, clipped to 0) too, last wins
    nb = covisible_neighbors(state, kf_id, 30, min_weight=15)
    group = set_last(K_, nb.clamp(min=0), nb >= 0, False)
    group[kf_id] = True
    group = group & state.kf_valid

    S_all = lie.sim3_from_se3(state.kf_pose)                     # [K, 8]
    rel = lie.sim3_compose(S_all, lie.sim3_inverse(S_cur)[None])
    S_corr = lie.sim3_compose(rel, Scm[None])

    # group points move with their first observing group keyframe
    okf = state.mp_obs_kf
    okf_s = okf.long().clamp(min=0)
    in_group = group[okf_s] & (okf >= 0)
    has_ref = torch.any(in_group, dim=1)
    ref_slot = torch.argmax(in_group.to(torch.int8), dim=1)
    ref_kf = okf_s[torch.arange(M, device=dev), ref_slot]
    p_corr = lie.sim3_apply(lie.sim3_inverse(S_corr[ref_kf]),
                            lie.sim3_apply(S_all[ref_kf], state.mp_pos))
    mp_pos = torch.where((has_ref & state.mp_valid)[:, None], p_corr,
                         state.mp_pos)
    kf_pose = torch.where(group[:, None], lie.sim3_to_se3(S_corr),
                          state.kf_pose)
    state = state._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    # loop-point fusion into the current keyframe
    state = _fuse_into(state, kf_id, loop_pids)

    # SearchAndFuse: project the loop neighbourhood's points into every
    # corrected-group keyframe (LoopClosing.cc:587-613, radius 4)
    K_cam = camera.intrinsics(cfg.camera, dev)
    sf = cfg.orb.scale_factor
    bounds = _bounds(cfg)
    loop_mask = _loop_points(state, cand_id)
    P = min(2048, M)
    sel = first_flagged(loop_mask, P)
    sel_ok = loop_mask[sel]
    gids = torch.cat([torch.tensor([kf_id], device=dev),
                      covisible_neighbors(state, kf_id, 7, min_weight=15)])
    for t in range(gids.shape[0]):
        g = gids[t].clamp(min=0)
        pc_g = lie.se3_apply(state.kf_pose[g], state.mp_pos[sel])
        uvp_g = camera.project(K_cam, pc_g)
        oct_g = predict_scale(torch.linalg.vector_norm(pc_g, dim=-1),
                              state.mp_max_dist[sel], sf, cfg.orb.n_levels)
        viz = sel_ok & (gids[t] >= 0) & (pc_g[:, 2] > 0) & \
            camera.in_image(uvp_g, bounds)
        mres = search.search_by_projection(
            uvp_g, oct_g, state.mp_desc[sel], viz, state.kf_uv[g],
            state.kf_octave[g], state.kf_desc[g], state.kf_angle[g],
            state.kf_kp_valid[g],
            cfg.loop.search_and_fuse_radius * sf ** oct_g.to(torch.float32),
            max_dist=cfg.match.th_low, ratio=None, oct_lo=-1, oct_hi=0)
        lp = set_last(state.kf_obs.shape[1], mres.idx, torch.where(
            mres.idx >= 0, sel.to(torch.int32), -1), -1)
        state = _fuse_into(state, g, lp)

    for t in range(gids.shape[0]):
        state = update_covisibility_for_kf(state, gids[t].clamp(min=0))
    state = update_covisibility_for_kf(state, kf_id)
    loop_edge = state.loop_edge.clone()
    loop_edge[kf_id, cand_id] = True
    loop_edge[cand_id, kf_id] = True
    state = state._replace(loop_edge=loop_edge)

    # --- essential graph (Optimizer.cc:781-1044) ---
    S_nodes = torch.where(group[:, None], S_corr,
                          lie.sim3_from_se3(state.kf_pose))
    E_cap = 8  # edges per keyframe slot: parent + loop edges + top covis
    covis_strong = torch.where(
        state.kf_valid[:, None] & state.kf_valid[None, :], state.covis,
        0) >= cfg.loop.essential_min_weight
    any_edge = covis_strong | state.loop_edge
    top_w, top_i = stable_topk(torch.where(
        any_edge, state.covis + state.loop_edge.to(torch.int32) * 1000, 0),
        E_cap - 1)
    ar = torch.arange(K_, dtype=torch.int32, device=dev)
    ei = torch.cat([ar] * (E_cap - 1) + [ar])
    ej = torch.cat([torch.where(top_w[:, e] > 0, top_i[:, e], -1).to(
        torch.int32) for e in range(E_cap - 1)] + [state.kf_parent])
    ok_e = (ej >= 0) & state.kf_valid[ei.long()] & \
        state.kf_valid[ej.long().clamp(min=0)] & (ei != ej)
    ejs = ej.clamp(min=0)
    # measurements from the pre-correction relative poses; only the loop
    # edge carries the verified Scm
    S_meas = lie.sim3_compose(S_all[ejs.long()],
                              lie.sim3_inverse(S_all[ei.long()]))
    S_loop = lie.sim3_compose(S_nodes[cand_id], lie.sim3_inverse(Scm))
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    node_fixed = torch.zeros(K_, dtype=torch.bool, device=dev)
    node_fixed[cand_id] = True
    prob = posegraph.PoseGraphProblem(
        nodes=S_nodes, node_valid=state.kf_valid, node_fixed=node_fixed,
        edge_i=torch.cat([ei, one(kf_id)]),
        edge_j=torch.cat([ejs, one(cand_id)]),
        edge_meas=torch.cat([S_meas, S_loop[None]]),
        edge_w=torch.cat([ok_e, torch.ones(1, dtype=torch.bool, device=dev)]
                         ).to(torch.float32),
        fix_scale=cfg.sensor != 0)
    nodes_opt, _ = posegraph.optimize_pose_graph(
        prob, n_outer=cfg.ba.ess_graph_iters, n_cg=40,
        lam0=cfg.ba.lambda_init_pose_graph + 1e-8)

    # write back: poses from the optimized Sim3; points through their
    # reference keyframe (Optimizer.cc:991-1043)
    kf_pose = torch.where(state.kf_valid[:, None],
                          lie.sim3_to_se3(nodes_opt), state.kf_pose)
    okf = state.mp_obs_kf
    has = okf >= 0
    ref_slot = torch.argmax(has.to(torch.int8), dim=1)
    ref = okf.long().clamp(min=0)[torch.arange(M, device=dev), ref_slot]
    p2 = lie.sim3_apply(lie.sim3_inverse(nodes_opt[ref]),
                        lie.sim3_apply(S_nodes[ref], state.mp_pos))
    moved = torch.any(has, 1) & state.mp_valid
    mp_pos = torch.where(moved[:, None], p2, state.mp_pos)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos,
                          big_change=state.big_change + 1)
