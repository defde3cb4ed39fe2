"""Chunked global bundle adjustment after a loop closure (port of
orb_slam2_tpu/ba/async_gba.py).

The reference runs post-loop global BA on a transient thread and merges the
result through spanning-tree propagation (LoopClosing.cc:576-749).  Here the
BA runs on a frozen snapshot of the map a few LM iterations at a time, one
chunk between frames, with the damping carried across chunks so the chunks
equal one long LM run; tracking extends the live map meanwhile.  When the
iteration budget is spent, `merge_gba` writes the optimized snapshot back
and corrects everything created since through the spanning tree.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.ba.local import (build_global_problem_point_major,
                                         point_major_widths)
from orb_slam2_tpu_torch.ba.schur import ba_solve
from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.map.state import MapState

# hops of spanning-tree propagation: more than the keyframes a chunked
# solve can see inserted (one chunk runs every frame)
MERGE_HOPS = 32


def merge_gba(state: MapState, ts_T, ref_kf, gba_pose, gba_points,
              snap_kf, snap_mp):
    """Fold a finished GBA into the live map.  snap_kf / snap_mp: validity
    at snapshot time.  Keyframes and points that existed then take their
    optimized values; newer keyframes are corrected through their spanning
    tree parent (`Tcw = Tchild_parent * Tcw_parent(GBA)`), newer points
    through their first observing keyframe.  Returns (state, corrected
    current pose)."""
    K_ = state.kf_pose.shape[0]
    M = state.mp_pos.shape[0]
    live = state.kf_pose
    in_snap = snap_kf & state.kf_valid
    par = state.kf_parent
    psafe = par.long().clamp(min=0)
    rel = lie.se3_compose(live, lie.se3_inverse(live[psafe]))
    pose = torch.where(in_snap[:, None], gba_pose, live)
    upd = ((~in_snap) & state.kf_valid & (par >= 0))[:, None]
    for _ in range(min(MERGE_HOPS, K_)):
        pose = torch.where(upd, lie.se3_compose(rel, pose[psafe]), pose)

    okf = state.mp_obs_kf
    has = okf >= 0
    ref_slot = torch.argmax(has.to(torch.int8), dim=1)
    r = okf.long().clamp(min=0)[torch.arange(M, device=okf.device), ref_slot]
    pc = lie.se3_apply(live[r], state.mp_pos)
    p_corr = lie.se3_apply(lie.se3_inverse(pose[r]), pc)
    take_gba = (snap_mp & state.mp_valid)[:, None]
    movable = (torch.any(has, 1) & state.mp_valid)[:, None]
    mp_pos = torch.where(take_gba, gba_points,
                         torch.where(movable, p_corr, state.mp_pos))

    # the current pose rides its reference keyframe's correction
    rk = ref_kf.long().clamp(min=0)
    T_new = lie.se3_compose(lie.se3_compose(ts_T, lie.se3_inverse(live[rk])),
                            pose[rk])
    state = state._replace(kf_pose=pose, mp_pos=mp_pos,
                           big_change=state.big_change + 1)
    return state, T_new


class AsyncGBA:
    """Host-side runner of the chunked global BA, one per SLAM session.
    start() snapshots the map into a frozen problem; step() runs one chunk;
    merge() folds the result back.  Starting again while active discards
    the running solve (the reference's mbStopGBA abort,
    LoopClosing.cc:411-423)."""

    def __init__(self, cfg: SLAMConfig, iters_per_chunk: int = 2,
                 n_cg: int = 50):
        self.cfg = cfg
        # n_cg keeps each LM step near-exact (the reference solves the
        # reduced system exactly): weak CG stalls the chunked solve
        self.iters_per_chunk = iters_per_chunk
        self.n_cg = n_cg
        self.active = False

    def start(self, state: MapState, total_iters: int):
        # a frozen snapshot: the session writes its state in place every
        # frame, so the problem and the validity masks must not alias it
        prob = build_global_problem_point_major(state, self.cfg)
        self.prob = type(prob)(*(x.clone() if isinstance(x, torch.Tensor)
                                 else x for x in prob))
        self.widths = point_major_widths(state)
        self.snap_kf = state.kf_valid.clone()
        self.snap_mp = state.mp_valid.clone()
        self.carry = (self.prob.cam_pose, self.prob.points,
                      torch.tensor(1e-4, device=state.kf_pose.device))
        self.iters_left = total_iters
        self.active = True

    def cancel(self):
        self.active = False

    def step(self) -> bool:
        """Run one chunk; True once the budget is spent and merge() is due."""
        if not self.active:
            return False
        cam_pose, points, lam = self.carry
        res = ba_solve(self.prob._replace(cam_pose=cam_pose, points=points),
                       n_outer=self.iters_per_chunk, n_cg=self.n_cg,
                       lam0=lam, chi2_th_mono=self.cfg.ba.chi2_mono,
                       chi2_th_stereo=self.cfg.ba.chi2_stereo,
                       widths=self.widths)
        self.carry = (res.cam_pose, res.points, res.lam)
        self.iters_left -= self.iters_per_chunk
        return self.iters_left <= 0

    def merge(self, state: MapState, ts_T, ref_kf):
        self.active = False
        return merge_gba(state, ts_T, ref_kf, self.carry[0], self.carry[1],
                         self.snap_kf, self.snap_mp)
