"""Map initialization (port of orb_slam2_tpu/pipeline/init.py): the
monocular two-view bootstrap (reference Tracking::MonocularInitialization,
Tracking.cc:563-737) and the stereo/RGB-D one from a single frame
(Tracking::StereoInitialization, Tracking.cc:509-561)."""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import (MapState, mask_from_ids,
                                           one_or_many, seq_ids,
                                           update_covisibility_for_kf)
from orb_slam2_tpu_torch.matching import search
from orb_slam2_tpu_torch.pipeline.frame import Frame
from orb_slam2_tpu_torch.pipeline.tracking import OK, TrackState
from orb_slam2_tpu_torch.solvers import twoview


def store_init_frame(ts: TrackState, frame: Frame) -> TrackState:
    """Snapshot the first mono frame (reference Tracking.cc:567-580)."""
    return ts._replace(
        init_valid_frame=frame.n > 100,
        init_uv=frame.uv, init_angle=frame.angle, init_octave=frame.octave,
        init_desc=frame.desc, init_kp_valid=frame.valid,
        init_frame_id=frame.frame_id, init_timestamp=frame.timestamp)


def match_for_init(ts: TrackState, frame: Frame, cfg: SLAMConfig):
    """SearchForInitialization between the stored first frame and the
    current frame (reference Tracking.cc:593)."""
    return search.search_for_initialization(
        ts.init_uv, ts.init_desc, ts.init_angle, ts.init_octave,
        ts.init_kp_valid, frame.uv, frame.desc, frame.angle, frame.octave,
        frame.valid, window=float(cfg.match.init_window),
        max_dist=float(cfg.match.th_init), ratio=cfg.match.nn_ratio_init)


def pids_mask_from(pids: torch.Tensor, M: int) -> torch.Tensor:
    """[M] (or [S, M] for pids [S, R]) bool: the points in pids."""
    return mask_from_ids(pids, pids >= 0, M, seq=pids.dim() > 1)


def create_mono_map(state: MapState, ts: TrackState, frame: Frame,
                    match_idx: torch.Tensor, sets: torch.Tensor,
                    cfg: SLAMConfig):
    """Two-view reconstruction + initial map (reference
    Tracking::CreateInitialMapMonocular).  `sets` are the RANSAC sample
    index sets (twoview.sample_sets).  Returns (state, ts, ok); on ok: two
    keyframes and the triangulated points, scaled to median depth 1."""
    dev = frame.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    matched = match_idx >= 0
    uv2 = frame.uv[match_idx.long().clamp(min=0)]
    res = twoview.initialize(K, ts.init_uv, uv2, matched, sets, cfg.init)

    z = res.points[:, 2]
    good = res.good
    n_good = torch.clamp(torch.sum(good.to(torch.int32)), min=1)
    z_sorted = torch.sort(torch.where(good, z, float("inf")))[0]
    med = z_sorted[torch.clamp((n_good - 1) // 2, 0, z.shape[0] - 1)]
    inv_med = 1.0 / torch.clamp(med, min=1e-6)
    pts = res.points * inv_med
    T21 = torch.cat([res.T21[:4], res.T21[4:7] * inv_med])

    n = ts.init_uv.shape[0]
    none = torch.full((n,), -1.0, device=dev)
    no_pids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    f0 = Frame(uv=ts.init_uv, uv_raw=ts.init_uv, ur=none, depth=none,
               octave=ts.init_octave, angle=ts.init_angle, desc=ts.init_desc,
               valid=ts.init_kp_valid, frame_id=ts.init_frame_id,
               timestamp=ts.init_timestamp)
    state, k0 = ops.insert_keyframe(state, f0, lie.se3_identity(device=dev),
                                    no_pids)
    state, k1 = ops.insert_keyframe(state, frame, T21, no_pids)
    state, pids = ops.alloc_points(state, good & matched, pts, ts.init_desc,
                                   k0)
    ar = torch.arange(n, device=dev)
    state = ops.add_obs(state, k0, ar, pids)
    # pid rows (indexed by init keypoint) onto current-frame keypoint slots
    tgt = torch.where(pids >= 0, match_idx.long().clamp(min=0), n)
    cur_pids = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    cur_pids[tgt] = pids
    cur_pids = cur_pids[:n]
    state = ops.add_obs(state, k1, ar, cur_pids)
    state = update_covisibility_for_kf(state, k1)
    state = ops.update_point_attributes(
        state, pids_mask_from(pids, state.mp_pos.shape[0]),
        cfg.orb.scale_factor, cfg.orb.n_levels)

    ident = lie.se3_identity(device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    ts = ts._replace(
        status=i32(OK), T=T21, last_T=T21, velocity=ident,
        has_velocity=torch.tensor(False, device=dev),
        last_pids=cur_pids, last_uv=frame.uv, last_octave=frame.octave,
        last_angle=frame.angle, last_valid=frame.valid,
        last_desc=frame.desc, last_depth=frame.depth,
        ref_kf=k1.to(torch.int32), last_kf_frame_id=frame.frame_id,
        init_valid_frame=torch.tensor(False, device=dev))
    # log the first init frame's pose (identity at KF0) so exports start at
    # the true sequence start
    i0 = int(ts.init_frame_id.clamp(0, ts.traj.shape[0] - 1))
    row0 = torch.cat([ident, ident, torch.stack([
        k0.to(torch.float32), torch.ones((), device=dev),
        ts.init_timestamp.to(torch.float32)])])
    traj = ts.traj.clone()
    traj[i0] = row0
    return state, ts._replace(traj=traj), res.ok


@one_or_many
def stereo_initialize(state: MapState, ts: TrackState, frame: Frame,
                      cfg: SLAMConfig):
    """Stereo/RGB-D bootstrap of each sequence from its frame (a leading
    [S] axis): pose = identity, every keypoint with depth becomes a map
    point (reference Tracking.cc:509-561).  Returns (state, ts, ok [S])."""
    dev = frame.uv.device
    S, n = frame.uv.shape[:2]
    K = camera.intrinsics(cfg.camera, dev)
    has_depth = frame.valid & (frame.depth > 0)
    pw = camera.unproject(K, frame.uv, frame.depth)  # camera == world
    ident = lie.se3_identity((S,), device=dev)
    state, k0 = ops.insert_keyframe(
        state, frame, ident, torch.full((S, n), -1, dtype=torch.int32,
                                        device=dev))
    state, pids = ops.alloc_points(state, has_depth, pw, frame.desc, k0)
    state = ops.add_obs(state, k0, torch.arange(n, device=dev).expand(S, n),
                        pids)
    state = ops.update_point_attributes(
        state, pids_mask_from(pids, state.mp_pos.shape[-2]),
        cfg.orb.scale_factor, cfg.orb.n_levels)
    ts = ts._replace(
        status=torch.full((S,), OK, dtype=torch.int32, device=dev),
        T=ident, last_T=ident.clone(), velocity=ident.clone(),
        has_velocity=torch.zeros(S, dtype=torch.bool, device=dev),
        last_pids=pids, last_uv=frame.uv, last_octave=frame.octave,
        last_angle=frame.angle, last_valid=frame.valid,
        last_desc=frame.desc, last_depth=frame.depth,
        ref_kf=k0.to(torch.int32),
        last_kf_frame_id=seq_ids(frame.frame_id, S, dev).to(torch.int32))
    return state, ts, frame.n >= cfg.tracking.stereo_init_min_kps
