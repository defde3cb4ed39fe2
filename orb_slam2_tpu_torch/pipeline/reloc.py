"""Relocalisation: recover a lost tracker by place recognition + EPnP (port
of orb_slam2_tpu/pipeline/reloc.py; reference Tracking::Relocalization,
Tracking.cc:1341-1502).

BoW vector -> relocalisation candidates -> per candidate: brute-force
descriptor match, EPnP RANSAC, motion-only BA, two rounds of
guided-reprojection top-up (window 10 / Hamming 100, then window 3 /
Hamming 64, re-optimizing after each) -> the best good candidate wins.
Candidates are tried in the same order and judged by the same rule as in
JAX.  Every pose LM goes through `pose_opt.pose_optimize`, so on the card
each is one launch of the pose-LM kernel.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.map.state import (MapState, mask_from_ids,
                                           resolve_replaced, set_last)
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline.frame import Frame
from orb_slam2_tpu_torch.pipeline.tracking import predict_scale
from orb_slam2_tpu_torch.place import database
from orb_slam2_tpu_torch.solvers import epnp, pose_opt
from orb_slam2_tpu_torch.solvers.twoview import sets_from_uniform

N_CAND = 4
PNP_ITERS = 64
PNP_SAMPLE = 6


def build_reloc_step(cfg: SLAMConfig, transform):
    """transform: the vocabulary transform (desc, valid) -> (bow, ...).

    Returns reloc(state, frame, u) -> (ok, T [7], pids [N], cand id), u
    [N_CAND, PNP_ITERS, PNP_SAMPLE] being uniform draws in [0, 1) from which
    each candidate's EPnP RANSAC samples are taken among its matched
    keypoints (`twoview.sets_from_uniform`)."""
    bf = cfg.camera.bf
    sf = cfg.orb.scale_factor
    bounds = (0.0, float(cfg.camera.width), 0.0, float(cfg.camera.height))

    def try_candidate(state: MapState, frame: Frame, c, u, K):
        N = frame.uv.shape[0]
        M = state.mp_pos.shape[0]
        cs = c.long().clamp(min=0)
        kf_pids = state.kf_obs[cs]
        ok_row = (c >= 0) & (kf_pids >= 0) & \
            state.mp_valid[kf_pids.long().clamp(min=0)] & state.kf_kp_valid[cs]
        dist = hamming.hamming_matrix(state.kf_desc[cs], frame.desc)
        res = search.match_descriptors(
            dist, torch.ones_like(dist, dtype=torch.bool), cfg.match.th_low,
            cfg.match.nn_ratio_reloc_bow, ok_row, frame.valid)
        idx = search.rotation_consistency(state.kf_angle[cs], frame.angle,
                                          res.idx, cfg.match.histo_length)
        pids = set_last(N, idx, torch.where(idx >= 0, kf_pids, -1), -1)
        valid = pids >= 0
        pw = state.mp_pos[pids.long().clamp(min=0)]
        sig2 = (sf ** frame.octave.to(torch.float32)) ** 2
        rr = epnp.pnp_ransac(sets_from_uniform(u, valid), pw, frame.uv,
                             valid, K, cfg.pnp.th2 * sig2,
                             min_inliers=cfg.pnp.min_inliers)
        inv_sigma2 = 1.0 / sig2
        is_st = frame.ur >= 0
        opt = pose_opt.pose_optimize(rr.T, pw, frame.uv, frame.ur, inv_sigma2,
                                     valid & rr.inliers, is_st, K, bf, cfg.ba)
        pids_final = torch.where(opt.inliers, pids, -1)

        # guided-reprojection escalation (Tracking.cc:1449-1487): project
        # the candidate's points at the current estimate, top up matches,
        # re-optimize
        kf_all = resolve_replaced(state, state.kf_obs[cs])
        kf_safe = kf_all.long().clamp(min=0)
        kf_ok = ((c >= 0) & (kf_all >= 0) & state.mp_valid[kf_safe] &
                 state.kf_kp_valid[cs])
        pw_kf = state.mp_pos[kf_safe]

        def topup(T_in, pids_in, window, max_d):
            already = mask_from_ids(pids_in, pids_in >= 0, M)
            pc = lie.se3_apply(T_in, pw_kf)
            uv_pred = camera.project(K, pc)
            src_ok = kf_ok & ~already[kf_safe] & (pc[:, 2] > 0) & \
                camera.in_image(uv_pred, bounds)
            cam_c = -lie.quat_rotate(lie.quat_conj(T_in[:4]), T_in[4:7])
            d = torch.linalg.vector_norm(pw_kf - cam_c, dim=-1)
            pred = predict_scale(d, state.mp_max_dist[kf_safe], sf,
                                 cfg.orb.n_levels)
            res2 = search.search_by_projection(
                uv_pred, pred, state.mp_desc[kf_safe], src_ok,
                frame.uv, frame.octave, frame.desc, frame.angle,
                frame.valid & (pids_in < 0),
                window * sf ** pred.to(torch.float32), max_dist=max_d,
                ratio=None, oct_lo=-1, oct_hi=1)
            add = set_last(N, res2.idx,
                           torch.where(res2.idx >= 0, kf_all, -1), -1)
            pids_up = torch.where(pids_in >= 0, pids_in, add)
            opt_up = pose_opt.pose_optimize(
                T_in, state.mp_pos[pids_up.long().clamp(min=0)], frame.uv,
                frame.ur, inv_sigma2, pids_up >= 0, is_st, K, bf, cfg.ba)
            return opt_up, torch.where(opt_up.inliers, pids_up, -1)

        # round 1: window 10, ORB distance 100 (Tracking.cc:1459)
        opt_b, pids_b = topup(opt.T, pids_final, 10.0, 100)
        use_b = (opt.n_inliers < 50) & (opt.n_inliers > 10) & \
            (opt_b.n_inliers > opt.n_inliers)
        T1 = torch.where(use_b, opt_b.T, opt.T)
        inl1 = torch.where(use_b, opt_b.n_inliers, opt.n_inliers)
        pids1 = torch.where(use_b, pids_b, pids_final)
        # round 2: window 3, ORB distance 64 (Tracking.cc:1472)
        opt_c, pids_c = topup(T1, pids1, 3.0, 64)
        use_c = (inl1 > 30) & (inl1 < 50) & (opt_c.n_inliers > inl1)
        T2 = torch.where(use_c, opt_c.T, T1)
        inl2 = torch.where(use_c, opt_c.n_inliers, inl1)
        pids2 = torch.where(use_c, pids_c, pids1)
        good = rr.ok & (inl2 >= 50)   # Tracking.cc:1487 gate
        return good, T2, inl2, pids2

    def reloc(state: MapState, frame: Frame, u: torch.Tensor):
        K = camera.intrinsics(cfg.camera, frame.uv.device)
        bow, _, _ = transform(frame.desc, frame.valid)
        cands = database.detect_reloc_candidates(
            state.kf_bow, state.kf_valid, state.covis, bow, n_out=N_CAND)
        outs = [try_candidate(state, frame, cands.ids[i], u[i], K)
                for i in range(N_CAND)]
        goods = torch.stack([o[0] for o in outs])
        n_inls = torch.stack([o[2] for o in outs])
        best = torch.argmax(torch.where(goods, n_inls, -1))
        ok = torch.any(goods)
        return (ok, torch.stack([o[1] for o in outs])[best],
                torch.stack([o[3] for o in outs])[best],
                torch.where(ok, cands.ids[best], -1))

    return reloc
