"""Per-frame tracking (port of orb_slam2_tpu/pipeline/tracking.py).

Each phase is a function over (MapState, TrackState, Frame).  Where the JAX
step branches with `lax.cond` (motion model vs reference keyframe), this
port branches on the host: the flag is one scalar read per frame.

`cur_pids [N]` — the map-point id matched to each current keypoint (-1 =
none) — plays the role of the reference's `Frame::mvpMapPoints`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.map.state import (MapState, count_ids, first_flagged,
                                           mask_from_ids, resolve_replaced,
                                           stable_topk)
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline.frame import Frame
from orb_slam2_tpu_torch.solvers import pose_opt

# status codes (reference Tracking.h:81-87)
NO_IMAGES = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3

# HUD: the small int32 vector the host reads to drive its reactions
HUD_STATUS = 0
HUD_N_INLIERS = 1
HUD_NEED_KF = 2
HUD_N_KF = 3
HUD_N_MP = 4
HUD_REF_KF = 5
HUD_LEN = 6


class TrackState(NamedTuple):
    status: torch.Tensor       # i32
    T: torch.Tensor            # [7] current Tcw
    velocity: torch.Tensor     # [7] Tcw_cur * Twc_last
    has_velocity: torch.Tensor  # bool
    last_T: torch.Tensor       # [7]
    last_pids: torch.Tensor    # [N] i32
    last_uv: torch.Tensor      # [N, 2]
    last_octave: torch.Tensor  # [N] i32
    last_angle: torch.Tensor   # [N]
    last_valid: torch.Tensor   # [N] bool
    last_desc: torch.Tensor    # [N, 32] u8
    last_depth: torch.Tensor   # [N]
    ref_kf: torch.Tensor       # i32
    last_kf_frame_id: torch.Tensor  # i32
    last_reloc_frame_id: torch.Tensor  # i32
    init_valid_frame: torch.Tensor  # bool
    init_uv: torch.Tensor      # [N, 2]
    init_angle: torch.Tensor   # [N]
    init_octave: torch.Tensor  # [N] i32
    init_desc: torch.Tensor    # [N, 32]
    init_kp_valid: torch.Tensor  # [N] bool
    init_frame_id: torch.Tensor  # i32
    init_timestamp: torch.Tensor  # f32
    map_kf: torch.Tensor       # i32 keyframe being integrated (-1 idle)
    map_stage: torch.Tensor    # i32 next integration stage
    ba_lam: torch.Tensor       # f32 LM damping carried across BA chunks
    # packed [F, 17] trajectory log: cols 0:7 Tcw, 7:14 Tcr (relative to the
    # reference KF), 14 ref KF id, 15 ok flag, 16 timestamp
    traj: torch.Tensor


def empty_track_state(cfg: SLAMConfig, device=None) -> TrackState:
    N = cfg.orb.max_keypoints
    i32, f32 = torch.int32, torch.float32
    kw = dict(device=device)
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, **kw)
    traj = torch.zeros((cfg.cap.max_frames, 17), dtype=f32, **kw)
    traj[:, 0] = 1.0
    traj[:, 7] = 1.0
    traj[:, 14] = -1.0
    ident = lie.se3_identity(device=device)
    return TrackState(
        status=scalar(NOT_INITIALIZED, i32),
        T=ident.clone(), velocity=ident.clone(),
        has_velocity=scalar(False, torch.bool),
        last_T=ident.clone(),
        last_pids=torch.full((N,), -1, dtype=i32, **kw),
        last_uv=torch.zeros((N, 2), dtype=f32, **kw),
        last_octave=torch.zeros(N, dtype=i32, **kw),
        last_angle=torch.zeros(N, dtype=f32, **kw),
        last_valid=torch.zeros(N, dtype=torch.bool, **kw),
        last_desc=torch.zeros((N, 32), dtype=torch.uint8, **kw),
        last_depth=torch.full((N,), -1.0, dtype=f32, **kw),
        ref_kf=scalar(-1, i32),
        last_kf_frame_id=scalar(-1, i32),
        last_reloc_frame_id=scalar(-1000000, i32),
        init_valid_frame=scalar(False, torch.bool),
        init_uv=torch.zeros((N, 2), dtype=f32, **kw),
        init_angle=torch.zeros(N, dtype=f32, **kw),
        init_octave=torch.zeros(N, dtype=i32, **kw),
        init_desc=torch.zeros((N, 32), dtype=torch.uint8, **kw),
        init_kp_valid=torch.zeros(N, dtype=torch.bool, **kw),
        init_frame_id=scalar(-1, i32),
        init_timestamp=scalar(0.0, f32),
        map_kf=scalar(-1, i32),
        map_stage=scalar(0, i32),
        ba_lam=scalar(1e-4, f32),
        traj=traj)


def record_traj(state: MapState, ts: TrackState, frame: Frame,
                ok) -> TrackState:
    """Log this frame's pose (Tcw and Tcr relative to the reference KF)."""
    i = int(frame.frame_id.clamp(0, ts.traj.shape[0] - 1))
    ref = ts.ref_kf.long().clamp(min=0)
    rel = lie.se3_compose(ts.T, lie.se3_inverse(state.kf_pose[ref]))
    dev = ts.T.device
    row = torch.cat([ts.T, rel, torch.stack([
        ts.ref_kf.to(torch.float32),
        torch.as_tensor(ok, dtype=torch.float32, device=dev).reshape(()),
        frame.timestamp.to(torch.float32).reshape(())])])
    traj = ts.traj.clone()
    traj[i] = row
    return ts._replace(traj=traj)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor,
                  scale_factor: float, n_levels: int) -> torch.Tensor:
    """Predicted pyramid level from distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    log_sf = float(np.log(np.float32(scale_factor)))   # f32, as in JAX
    lvl = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def _pose_opt_from_pos(frame: Frame, pw, valid, T0, K, bf, cfg):
    inv_sigma2 = 1.0 / (cfg.orb.scale_factor ** 2) ** frame.octave.to(
        torch.float32)
    return pose_opt.pose_optimize(T0, pw, frame.uv, frame.ur, inv_sigma2,
                                  valid & frame.valid, frame.ur >= 0, K, bf,
                                  cfg.ba)


def _pose_opt_from_pids(state: MapState, frame: Frame, pids, T0, K, bf, cfg):
    safe = pids.long().clamp(min=0)
    return _pose_opt_from_pos(frame, state.mp_pos[safe], pids >= 0, T0, K,
                              bf, cfg)


def _scatter_to_kps(idx: torch.Tensor, vals: torch.Tensor, N: int,
                    fill) -> torch.Tensor:
    """out[idx[i]] = vals[i] for idx >= 0 (matched keypoints are distinct)."""
    tgt = torch.where(idx >= 0, idx.long(), N)
    out = torch.full((N + 1,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    out[tgt] = vals
    return out[:N]


def _bounds(cfg: SLAMConfig):
    return (0.0, float(cfg.camera.width), 0.0, float(cfg.camera.height))


# ---------------------------------------------------------------------------
# tracking phases
# ---------------------------------------------------------------------------

def track_with_motion_model(state: MapState, ts: TrackState, frame: Frame,
                            cfg: SLAMConfig):
    """Reference Tracking::TrackWithMotionModel: constant-velocity
    prediction, project last frame's points, windowed search, pose
    optimization.  Returns (cur_pids [N], pose-opt result, ok)."""
    dev = frame.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    bf = cfg.camera.bf
    T_pred = lie.se3_compose(ts.velocity, ts.last_T)

    pids = resolve_replaced(state, ts.last_pids)
    safe = pids.long().clamp(min=0)
    pt_valid = (pids >= 0) & ts.last_valid & state.mp_valid[safe]
    pw = state.mp_pos[safe]
    desc = state.mp_desc[safe]
    pc = lie.se3_apply(T_pred, pw)
    uv_pred = camera.project(K, pc)
    pt_valid = pt_valid & (pc[..., 2] > 0) & camera.in_image(uv_pred,
                                                            _bounds(cfg))
    th = float(cfg.match.search_window_track if cfg.sensor != 0
               else cfg.match.search_window_track_mono)
    radius = th * cfg.orb.scale_factor ** ts.last_octave.to(torch.float32)

    res = search.search_by_projection(
        uv_pred, ts.last_octave, desc, pt_valid,
        frame.uv, frame.octave, frame.desc, frame.angle, frame.valid,
        radius, max_dist=cfg.match.th_high, ratio=None, oct_lo=-1, oct_hi=1)
    idx = search.rotation_consistency(ts.last_angle, frame.angle, res.idx,
                                      cfg.match.histo_length)
    N = frame.uv.shape[0]
    cur_pids = _scatter_to_kps(idx, torch.where(idx >= 0, pids, -1), N, -1)
    cur_pos = _scatter_to_kps(idx, pw, N, 0.0)
    cur_has = _scatter_to_kps(idx, idx >= 0, N, False)

    n_matches = torch.sum(cur_has.to(torch.int32))
    opt = _pose_opt_from_pos(frame, cur_pos, cur_has, T_pred, K, bf, cfg)
    cur_pids = torch.where(opt.inliers, cur_pids, -1)
    ok = (n_matches >= cfg.tracking.min_matches_motion) & \
         (opt.n_inliers >= cfg.tracking.min_inliers_track)
    return cur_pids, opt, ok


def track_reference_keyframe(state: MapState, ts: TrackState, frame: Frame,
                             cfg: SLAMConfig):
    """Reference Tracking::TrackReferenceKeyFrame: descriptor match against
    the reference KF (brute-force in place of SearchByBoW), pose
    optimization from the last pose."""
    dev = frame.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    bf = cfg.camera.bf
    r = ts.ref_kf.long()
    kf_pids = resolve_replaced(state, state.kf_obs[r])
    safe = kf_pids.long().clamp(min=0)
    row_valid = (kf_pids >= 0) & state.kf_kp_valid[r] & state.mp_valid[safe]
    dist = hamming.hamming_matrix(state.kf_desc[r], frame.desc)
    res = search.match_descriptors(
        dist, torch.ones_like(dist, dtype=torch.bool), cfg.match.th_low,
        cfg.match.nn_ratio_track_ref, row_valid, frame.valid)
    idx = search.rotation_consistency(state.kf_angle[r], frame.angle, res.idx,
                                      cfg.match.histo_length)
    N = frame.uv.shape[0]
    cur_pids = _scatter_to_kps(idx, torch.where(idx >= 0, kf_pids, -1), N, -1)
    n_matches = torch.sum((cur_pids >= 0).to(torch.int32))
    opt = _pose_opt_from_pids(state, frame, cur_pids, ts.last_T, K, bf, cfg)
    cur_pids = torch.where(opt.inliers, cur_pids, -1)
    ok = (n_matches >= cfg.tracking.min_matches_ref_kf) & \
         (opt.n_inliers >= cfg.tracking.min_inliers_track)
    return cur_pids, opt, ok


def track_local_map(state: MapState, ts: TrackState, frame: Frame,
                    T: torch.Tensor, cur_pids: torch.Tensor, cfg: SLAMConfig,
                    after_reloc: torch.Tensor):
    """Reference Tracking::TrackLocalMap + SearchLocalPoints: the local
    keyframes (voters K1 + their covisible neighbours K2), every point they
    observe, frustum gates, projection search, pose optimization.
    Returns ((visible delta, found delta), cur_pids, opt, ok)."""
    dev = frame.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    bf = cfg.camera.bf
    M = state.mp_pos.shape[0]
    K_ = state.kf_obs.shape[0]

    safe_c = cur_pids.long().clamp(min=0)
    obs_kf_cur = state.mp_obs_kf[safe_c]                  # [N, D]
    vote_ok = (cur_pids >= 0)[:, None] & (obs_kf_cur >= 0)
    votes = count_ids(obs_kf_cur, vote_ok, K_)
    topv, topk = stable_topk(votes, min(cfg.cap.local_window, K_))
    k1_mask = mask_from_ids(topk, topv > 0, K_) & state.kf_valid
    nb_mask = torch.any(k1_mask[:, None] & (state.covis > 0), dim=0)
    local_kf = (k1_mask | nb_mask) & state.kf_valid
    lobs = state.kf_obs
    pt_local = mask_from_ids(lobs, local_kf[:, None] & (lobs >= 0), M)

    pc = lie.se3_apply(T, state.mp_pos)
    uv_pred = camera.project(K, pc)
    rel = state.mp_pos + lie.quat_rotate(lie.quat_conj(lie.se3_q(T)),
                                         lie.se3_t(T))   # p - camera centre
    dist = torch.linalg.vector_norm(rel, dim=-1)
    view_cos = torch.sum(rel * state.mp_normal, -1) / torch.clamp(dist,
                                                                 min=1e-9)
    in_band = (dist >= 0.8 * state.mp_min_dist) & \
        (dist <= 1.2 * state.mp_max_dist)
    visible = (state.mp_valid & pt_local & (pc[:, 2] > 0) &
               camera.in_image(uv_pred, _bounds(cfg)) & in_band &
               (view_cos > 0.5))

    already = mask_from_ids(cur_pids, cur_pids >= 0, M)
    pred_oct = predict_scale(dist, state.mp_max_dist, cfg.orb.scale_factor,
                             cfg.orb.n_levels)
    r_base = torch.where(view_cos > 0.998, 2.5, 4.0)
    th = torch.where(after_reloc, 5.0, 1.0)
    radius = r_base * th * cfg.orb.scale_factor ** pred_oct.to(torch.float32)

    P = min(4096, M)
    searchable = visible & ~already
    sel = first_flagged(searchable, P)
    sel_ok = searchable[sel]
    res = search.search_by_projection(
        uv_pred[sel], pred_oct[sel], state.mp_desc[sel], sel_ok,
        frame.uv, frame.octave, frame.desc, frame.angle,
        frame.valid & (cur_pids < 0),
        radius[sel], max_dist=cfg.match.th_high,
        ratio=cfg.match.nn_ratio_local, oct_lo=-1, oct_hi=0)
    N = frame.uv.shape[0]
    add_pids = _scatter_to_kps(res.idx, torch.where(res.idx >= 0, sel, -1), N,
                               -1)
    cur_pids = torch.where(cur_pids >= 0, cur_pids, add_pids)

    opt = _pose_opt_from_pids(state, frame, cur_pids, T, K, bf, cfg)
    cur_pids = torch.where(opt.inliers, cur_pids, -1).to(torch.int32)
    found = count_ids(cur_pids, cur_pids >= 0, M)
    min_inl = torch.where(after_reloc,
                          cfg.tracking.min_inliers_local_map_reloc,
                          cfg.tracking.min_inliers_local_map)
    ok = opt.n_inliers >= min_inl
    return (visible.to(torch.int32), found), cur_pids, opt, ok


# ---------------------------------------------------------------------------
# per-frame step
# ---------------------------------------------------------------------------

def build_track_step(cfg: SLAMConfig):
    """Returns the per-frame step

        (state, ts, frame) -> (state, ts, cur_pids [N], hud [5] int32)

    covering TrackWithMotionModel / TrackReferenceKeyFrame fallback /
    TrackLocalMap / bookkeeping / NeedNewKeyFrame (reference
    Tracking::Track, Tracking.cc:267-506)."""
    def step(state: MapState, ts: TrackState, frame: Frame):
        # --- phase 1: motion model, reference-KF fallback (host branch) ---
        if bool(ts.has_velocity):
            pids, opt, ok1 = track_with_motion_model(state, ts, frame, cfg)
            if not bool(ok1):
                pids, opt, ok1 = track_reference_keyframe(state, ts, frame,
                                                          cfg)
        else:
            pids, opt, ok1 = track_reference_keyframe(state, ts, frame, cfg)
        T = opt.T

        # --- phase 2: local map ---
        after_reloc = (frame.frame_id - ts.last_reloc_frame_id) < \
            cfg.tracking.reloc_recent_window
        (vis_d, found_d), pids2, opt2, ok2 = track_local_map(
            state, ts, frame, T, pids, cfg, after_reloc)
        ok = ok1 & ok2
        oki = ok.to(torch.int32)
        state = state._replace(mp_visible=state.mp_visible + oki * vis_d,
                               mp_found=state.mp_found + oki * found_d)
        T = torch.where(ok, opt2.T, ts.T)
        cur_pids = torch.where(ok, pids2, -1)

        # --- phase 3: bookkeeping ---
        velocity = lie.se3_compose(T, lie.se3_inverse(ts.last_T))
        sel = lambda new, old: torch.where(ok, new, old)
        new_ts = ts._replace(
            status=torch.where(ok, OK, LOST).to(torch.int32),
            T=T, velocity=sel(velocity, ts.velocity), has_velocity=ok,
            last_T=sel(T, ts.last_T),
            last_pids=sel(cur_pids, ts.last_pids),
            last_uv=sel(frame.uv, ts.last_uv),
            last_octave=sel(frame.octave, ts.last_octave),
            last_angle=sel(frame.angle, ts.last_angle),
            last_valid=sel(frame.valid, ts.last_valid),
            last_desc=sel(frame.desc, ts.last_desc),
            last_depth=sel(frame.depth, ts.last_depth))

        # --- phase 4: keyframe decision (reference Tracking.cc:977-1061) ---
        n_kf = state.n_kf
        min_obs = torch.where(n_kf <= 2, 2, cfg.tracking.kf_min_obs)
        robs = state.kf_obs[ts.ref_kf.long().clamp(min=0)]
        psafe = robs.long().clamp(min=0)
        okf_r = state.mp_obs_kf[psafe].long()
        okp_r = state.mp_obs_kp[psafe].long()
        has_o = okf_r >= 0
        ur_r = state.kf_ur[okf_r.clamp(min=0), okp_r.clamp(min=0)]
        cnt_ref = torch.sum(torch.where(has_o, torch.where(ur_r >= 0, 2, 1),
                                        0), dim=1)
        n_ref = torch.sum(((robs >= 0) & (cnt_ref >= min_obs)).to(torch.int32))
        th_ratio = (cfg.tracking.kf_ref_ratio_mono if cfg.sensor == 0
                    else cfg.tracking.kf_ref_ratio_stereo)
        frames_since = frame.frame_id - ts.last_kf_frame_id
        n_inliers = opt2.n_inliers
        c1a = frames_since >= cfg.tracking.max_frames_hint
        gap_ok = frames_since >= cfg.tracking.min_kf_gap
        room = state.next_kf < state.kf_valid.shape[0] - 2
        c2 = (n_inliers < n_ref * th_ratio) & (n_inliers > 15)
        need_kf = ok & room & (c1a | (c2 & gap_ok))

        new_ts = record_traj(state, new_ts, frame, ok)
        hud = torch.stack([torch.where(ok, OK, LOST).to(torch.int32),
                           n_inliers.to(torch.int32),
                           need_kf.to(torch.int32),
                           n_kf.to(torch.int32),
                           state.n_mp.to(torch.int32)])
        return state, new_ts, cur_pids, hud

    return step
