"""Local and global bundle adjustment over the map state (port of
orb_slam2_tpu/ba/local.py).

Local BA (reference Optimizer::LocalBundleAdjustment): variable keyframes
= the new KF and its covisible neighbours, variable points = all they
observe, fixed anchors = the other observers of those points; outlier
observations are erased afterwards.  Observations are laid out camera-major
([C, N] rows flattened) with the mirror-transpose index `pt_obs_r` [P, D],
as `ba_solve_dense` requires.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.ba.schur import BAProblem, ba_solve, ba_solve_dense
from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import (MapState, count_ids,
                                           covisible_neighbors, first_flagged,
                                           last_writer, mask_from_ids,
                                           stable_topk)


def _obs_weight(state: MapState, cams, cfg: SLAMConfig):
    """inv_sigma2 per (cam slot, keypoint)."""
    oct_ = state.kf_octave[cams.long().clamp(min=0)]
    return (1.0 / cfg.orb.scale_factor ** 2) ** oct_.to(torch.float32)


def _index_of(ids: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """[n] inverse map: position of each id in `ids` (-1 if absent).  An id
    listed twice maps to its last position, as the JAX scatter leaves it."""
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=ids.device)
    pos = torch.arange(ids.shape[0], device=ids.device)
    win = last_writer(ids, ok, n)
    out[torch.where(win, ids.long(), n)] = pos
    return out[:n]


def build_local_problem(state: MapState, kf_id, cfg: SLAMConfig):
    """Returns (BAProblem, pt_obs_r [P, D], cams [C], psel [P], psel_ok)."""
    dev = state.kf_pose.device
    Lv = cfg.cap.local_ba_kfs
    Lf = cfg.cap.local_ba_fixed
    K_, N = state.kf_obs.shape
    M = state.mp_pos.shape[0]
    P = min(cfg.cap.local_ba_points, M)

    nb = covisible_neighbors(state, kf_id, Lv - 1, min_weight=1)
    local = torch.cat([torch.as_tensor(kf_id, device=dev).reshape(1).long(),
                       nb])                                          # [Lv]
    local_ok = local >= 0
    lsafe = local.clamp(min=0)

    lobs = state.kf_obs[lsafe]
    pmask = mask_from_ids(lobs, local_ok[:, None] & (lobs >= 0), M) & \
        state.mp_valid
    # fixed anchors: other observers of local points
    obs_kf = state.mp_obs_kf
    counts = count_ids(obs_kf, pmask[:, None] & (obs_kf >= 0), K_)
    # JAX sets this mask with `.at[lsafe].set(local_ok)`: padding slots
    # (-1, clipped to 0) write False over keyframe 0, so keyframe 0 counts
    # as an anchor candidate whenever the neighbour list is not full; the
    # last write to each id decides, as there
    last = last_writer(lsafe, torch.ones_like(local_ok), K_)
    is_local_kf = mask_from_ids(lsafe, last & local_ok, K_)
    counts = torch.where(is_local_kf, 0, counts)
    top_counts, fixed = stable_topk(counts, Lf)
    fixed = torch.where(top_counts > 0, fixed, -1)

    cams = torch.cat([local, fixed])                                # [C]
    C = cams.shape[0]
    csafe = cams.clamp(min=0)
    cam_ok = cams >= 0
    is_local = torch.arange(C, device=dev) < Lv
    # gauge: keyframe 0 is fixed; so is the anchor block
    cam_var = cam_ok & is_local & (cams != 0)
    slot_of = _index_of(csafe, cam_ok, K_)

    psel = first_flagged(pmask, P)
    psel_ok = pmask[psel]
    inv_sel = _index_of(psel, psel_ok, M)

    rows = state.kf_obs[csafe].long()                               # [C, N]
    pid_l = inv_sel[rows.clamp(min=0)]
    active = (cam_ok[:, None] & (rows >= 0) & (pid_l >= 0) &
              state.kf_kp_valid[csafe])
    pid_l = torch.where(active, pid_l, 0)

    okf = state.mp_obs_kf[psel].long()
    okp = state.mp_obs_kp[psel].long()
    oslot = slot_of[okf.clamp(min=0)]
    mir_ok = psel_ok[:, None] & (okf >= 0) & (oslot >= 0)
    r_idx = oslot.clamp(min=0) * N + okp.clamp(min=0)
    mir_ok = mir_ok & active[oslot.clamp(min=0), okp.clamp(min=0)]
    pt_obs_r = torch.where(mir_ok, r_idx, -1)

    R = C * N
    member = mask_from_ids(r_idx, mir_ok, R)
    w = torch.where(active, _obs_weight(state, cams, cfg), 0.0).reshape(-1)
    w = torch.where(member, w, 0.0)

    prob = BAProblem(
        cam_pose=state.kf_pose[csafe], cam_var=cam_var,
        points=state.mp_pos[psel], pt_var=psel_ok,
        obs_cam=torch.arange(C, device=dev).repeat_interleave(N),
        obs_pid=pid_l.reshape(-1),
        obs_uv=state.kf_uv[csafe].reshape(-1, 2),
        obs_ur=state.kf_ur[csafe].reshape(-1),
        obs_w=w, K=camera.intrinsics(cfg.camera, dev), bf=cfg.camera.bf)
    return prob, pt_obs_r, cams, psel, psel_ok


def local_ba(state: MapState, kf_id, cfg: SLAMConfig, n_outer: int = 10,
             lam0=1e-4, return_lam: bool = False):
    """Run local BA and write the results + outlier removal back.  With
    `return_lam=True` returns (state, final LM damping) so the chunked
    mapping stages resume where the previous chunk stopped."""
    prob, pt_obs_r, cams, psel, psel_ok = build_local_problem(state, kf_id,
                                                              cfg)
    K_, N = state.kf_obs.shape
    M = state.mp_pos.shape[0]
    res = ba_solve_dense(prob, pt_obs_r, n_per_cam=N, n_outer=n_outer,
                         lam0=lam0, chi2_th_mono=cfg.ba.chi2_mono,
                         chi2_th_stereo=cfg.ba.chi2_stereo)
    C = cams.shape[0]
    csafe = cams.clamp(min=0)
    tgt = torch.where(prob.cam_var, csafe, K_)
    pose_buf = torch.cat([state.kf_pose, torch.zeros_like(state.kf_pose[:1])])
    hit = torch.zeros(K_ + 1, dtype=torch.bool, device=cams.device)
    pose_buf[tgt] = res.cam_pose
    hit[tgt] = prob.cam_var
    kf_pose = torch.where(hit[:K_, None], pose_buf[:K_], state.kf_pose)
    ptgt = torch.where(psel_ok, psel, M)
    mp_pos = torch.cat([state.mp_pos, torch.zeros_like(state.mp_pos[:1])])
    mp_pos[ptgt] = res.points
    state = state._replace(kf_pose=kf_pose, mp_pos=mp_pos[:M])

    # erase outlier observations (reference Optimizer.cc:711-757)
    bad = ((prob.obs_w > 0) & ~res.inlier).reshape(C, N)
    # a keyframe may hold two camera slots (see build_local_problem): OR
    # their outlier rows, as JAX's `.at[].max` does, with an integer sum
    removal = torch.zeros((K_ + 1, N), dtype=torch.int32, device=cams.device
                          ).index_add_(0, torch.where(cams >= 0, csafe, K_),
                                       bad.to(torch.int32))
    state = ops.remove_obs_global(state, removal[:K_] > 0)
    if return_lam:
        return state, res.lam
    return state


def build_global_problem_point_major(state: MapState, cfg: SLAMConfig
                                     ) -> BAProblem:
    """Global BA problem, one observation row per (point, observer slot) of
    the mirror table: R = M * D."""
    K_, N = state.kf_obs.shape
    M, D = state.mp_obs_kf.shape
    dev = state.kf_pose.device
    okf, okp = state.mp_obs_kf.long(), state.mp_obs_kp.long()
    ks, ps = okf.clamp(min=0), okp.clamp(min=0)
    active = (state.mp_valid[:, None] & (okf >= 0) & state.kf_valid[ks] &
              state.kf_kp_valid[ks, ps] & (state.kf_obs[ks, ps] >= 0))
    oct_ = state.kf_octave[ks, ps]
    w = torch.where(active,
                    (1.0 / cfg.orb.scale_factor ** 2) ** oct_.to(torch.float32),
                    0.0)
    return BAProblem(
        cam_pose=state.kf_pose,
        cam_var=state.kf_valid & (torch.arange(K_, device=dev) != 0),
        points=state.mp_pos, pt_var=state.mp_valid,
        obs_cam=ks.reshape(-1),
        obs_pid=torch.arange(M, device=dev).repeat_interleave(D),
        obs_uv=state.kf_uv[ks, ps].reshape(-1, 2),
        obs_ur=torch.where(active, state.kf_ur[ks, ps], -1.0).reshape(-1),
        obs_w=w.reshape(-1), K=camera.intrinsics(cfg.camera, dev),
        bf=cfg.camera.bf)


def global_ba_cg(state: MapState, cfg: SLAMConfig, n_outer: int = 10,
                 n_cg: int = 50) -> MapState:
    """Full-map BA via the matrix-free CG solver on the point-major
    problem (memory O(R) rows + O(C) blocks)."""
    prob = build_global_problem_point_major(state, cfg)
    res = ba_solve(prob, n_outer=n_outer, n_cg=n_cg,
                   chi2_th_mono=cfg.ba.chi2_mono,
                   chi2_th_stereo=cfg.ba.chi2_stereo)
    kf_pose = torch.where(prob.cam_var[:, None], res.cam_pose, state.kf_pose)
    mp_pos = torch.where(state.mp_valid[:, None], res.points, state.mp_pos)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos)


# Above this camera count global BA takes the matrix-free CG path (the dense
# reduced system would be [6C, 6C]).
_GLOBAL_DENSE_MAX_CAMS = 256


def global_ba(state: MapState, cfg: SLAMConfig, n_outer: int = 10,
              n_cg: int = 50) -> MapState:
    """Full-map BA (reference Optimizer::GlobalBundleAdjustemnt): all valid
    KFs variable except KF 0."""
    if state.kf_obs.shape[0] > _GLOBAL_DENSE_MAX_CAMS:
        return global_ba_cg(state, cfg, n_outer=n_outer, n_cg=n_cg)
    K_, N = state.kf_obs.shape
    dev = state.kf_pose.device
    cams = torch.arange(K_, device=dev)
    cam_ok = state.kf_valid
    cam_var = cam_ok & (cams != 0)
    rows = state.kf_obs
    pid = rows.long().clamp(min=0)
    active = (cam_ok[:, None] & (rows >= 0) & state.mp_valid[pid] &
              state.kf_kp_valid)
    okf, okp = state.mp_obs_kf.long(), state.mp_obs_kp.long()
    mir_ok = state.mp_valid[:, None] & (okf >= 0) & cam_ok[okf.clamp(min=0)]
    r_idx = okf.clamp(min=0) * N + okp.clamp(min=0)
    mir_ok = mir_ok & active[okf.clamp(min=0), okp.clamp(min=0)]
    pt_obs_r = torch.where(mir_ok, r_idx, -1)
    member = mask_from_ids(r_idx, mir_ok, K_ * N)
    w = torch.where(active, _obs_weight(state, cams, cfg), 0.0).reshape(-1)
    w = torch.where(member, w, 0.0)
    prob = BAProblem(
        cam_pose=state.kf_pose, cam_var=cam_var,
        points=state.mp_pos, pt_var=state.mp_valid,
        obs_cam=cams.repeat_interleave(N), obs_pid=pid.reshape(-1),
        obs_uv=state.kf_uv.reshape(-1, 2), obs_ur=state.kf_ur.reshape(-1),
        obs_w=w, K=camera.intrinsics(cfg.camera, dev), bf=cfg.camera.bf)
    res = ba_solve_dense(prob, pt_obs_r, n_per_cam=N, n_outer=n_outer,
                         chi2_th_mono=cfg.ba.chi2_mono,
                         chi2_th_stereo=cfg.ba.chi2_stereo)
    kf_pose = torch.where(cam_var[:, None], res.cam_pose, state.kf_pose)
    mp_pos = torch.where(state.mp_valid[:, None], res.points, state.mp_pos)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos)
