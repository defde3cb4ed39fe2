"""Monocular SLAM session (port of orb_slam2_tpu/pipeline/system.py, the
monocular path without a vocabulary: no BoW, loop closing,
relocalization or asynchronous global BA).

Per frame: build the frame, track, decide on a keyframe, insert it, and
advance the pending keyframe's integration by one stage (triangulate, fuse,
3 local-BA chunks, cull) — the deterministic form of the reference's
LocalMapping thread.  The host reads a few scalars per frame (the
keyframe decision, the integration stage); the HUD that drives host
reactions (reset on early loss) is acted on `hud_lag` frames late, as in
the JAX package, so the reset timing matches.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List

import numpy as np
import torch

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.ba import local as ba_local
from orb_slam2_tpu_torch.config import MONOCULAR, SLAMConfig
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.map import ops
from orb_slam2_tpu_torch.map.state import MapState, empty_map
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import init as init_mod
from orb_slam2_tpu_torch.pipeline import mapping, tracking
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_N_KF, HUD_NEED_KF,
                                                   HUD_STATUS,
                                                   NOT_INITIALIZED, OK,
                                                   TrackState, record_traj)
from orb_slam2_tpu_torch.solvers import twoview

BA_ITERS = 5


def n_stages(cfg: SLAMConfig) -> int:
    """Integration stages per keyframe: triangulate, fuse, the BA chunks
    (5 LM iterations each, damping carried across), culls."""
    total_ba = cfg.ba.local_ba_iters1 + cfg.ba.local_ba_iters2
    return 2 + max(-(-total_ba // BA_ITERS), 1) + 1


def insert_kf(state: MapState, ts: TrackState, frame, cur_pids,
              cfg: SLAMConfig):
    """Insert the tracked frame as a keyframe and arm its integration."""
    state, kf_id = ops.insert_keyframe(state, frame, ts.T, cur_pids)
    dev = ts.T.device
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    ts = ts._replace(ref_kf=i32(kf_id), last_kf_frame_id=frame.frame_id,
                     map_kf=i32(kf_id), map_stage=i32(0),
                     ba_lam=torch.tensor(1e-4, device=dev))
    return state, record_traj(state, ts, frame, True)


def mapping_stage(state: MapState, ts: TrackState, cfg: SLAMConfig):
    """Advance the pending keyframe's integration by one stage."""
    k = max(int(ts.map_kf), 0)
    stage = min(int(ts.map_stage), n_stages(cfg) - 1)
    if stage == 0:
        state = mapping.triangulate_new_points(state, k, cfg)
    elif stage == 1:
        state = mapping.fuse_neighbors(state, k, cfg)
    elif stage < n_stages(cfg) - 1:
        state, lam = ba_local.local_ba(state, k, cfg, n_outer=BA_ITERS,
                                       lam0=ts.ba_lam, return_lam=True)
        ts = ts._replace(ba_lam=lam)
    else:
        state = mapping.cull_points(state, k, cfg)
        state, ts = mapping.cull_redundant_keyframes(state, ts, k, cfg)
    nxt = stage + 1
    done = nxt >= n_stages(cfg)
    dev = ts.T.device
    ts = ts._replace(
        map_stage=torch.tensor(0 if done else nxt, dtype=torch.int32,
                               device=dev),
        map_kf=torch.tensor(-1, dtype=torch.int32, device=dev) if done
        else ts.map_kf)
    return state, ts


def build_full_step(cfg: SLAMConfig, device=None):
    """Returns the per-frame step

        (state, ts, img, frame_id, timestamp) -> (state, ts, frame, hud [6])

    extraction -> tracking -> keyframe decision -> conditional insertion ->
    one integration stage (JAX `full_step`, system.py:203-232)."""
    frame_fn = frame_mod.build_mono_frame_fn(cfg, device)
    track_step = tracking.build_track_step(cfg)

    def full_step(state, ts, img, frame_id, timestamp):
        frame = frame_fn(img, frame_id, timestamp)
        state, ts, cur_pids, hud = track_step(state, ts, frame)
        # while the previous KF's triangulation/fusion stages are pending,
        # defer; once only BA/cull stages remain, a new insertion aborts
        # them (reference LocalMapping::InsertKeyFrame / mbAbortBA)
        busy_early = int(ts.map_kf) >= 0 and int(ts.map_stage) <= 1
        need = bool(hud[HUD_NEED_KF]) and not busy_early
        if need:
            state, ts = insert_kf(state, ts, frame, cur_pids, cfg)
        if int(ts.map_kf) >= 0:
            state, ts = mapping_stage(state, ts, cfg)
        hud = hud.clone()
        hud[HUD_NEED_KF] = int(need)
        hud = torch.cat([hud, ts.ref_kf.reshape(1).to(torch.int32)])
        return state, ts, frame, hud

    return full_step


class SLAM:
    """One monocular SLAM session.  Usage:

        slam = SLAM(cfg)                    # CUDA; device="cpu" to opt out
        for img, t in sequence:
            slam.track_mono(img, t)
        slam.save_trajectory_tum("traj.txt")
    """

    def __init__(self, cfg: SLAMConfig, device=None, seed: int = 0):
        if cfg.sensor != MONOCULAR:
            raise NotImplementedError("this port runs the monocular path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = empty_map(cfg, self.device)
        self.ts = tracking.empty_track_state(cfg, self.device)
        self.frame_count = 0
        self.status = NOT_INITIALIZED
        self.last_hud = np.zeros(8, np.int32)
        self.timings: List[float] = []
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.hud_lag = 8
        self._pending: deque = deque()
        self._frame_fn = frame_mod.build_mono_frame_fn(cfg, self.device)
        self._full_step = build_full_step(cfg, self.device)

    # ------------------------------------------------------------------
    def track_mono(self, img: np.ndarray, timestamp: float):
        t0 = time.perf_counter()
        img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        if self.status == NOT_INITIALIZED:
            frame = self._frame_fn(img, self.frame_count, timestamp)
            self._initialize(frame)
        else:
            self.state, self.ts, _, hud = self._full_step(
                self.state, self.ts, img, self.frame_count, timestamp)
            self._pending.append(hud.cpu().numpy())
            self._drain(self.hud_lag)
        self.frame_count += 1
        self.timings.append(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def flush(self):
        """Process pending HUD entries and finish the staged integration of
        the last keyframe.  Call before reading trajectories or counters."""
        self._drain(0)
        for _ in range(16):
            if int(self.ts.map_kf) < 0:
                break
            self.state, self.ts = mapping_stage(self.state, self.ts, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _drain(self, keep: int):
        """React to HUD entries older than `keep` frames: lost within the
        first 5 keyframes -> reset (reference Tracking.cc:472-480)."""
        while len(self._pending) > keep:
            hud = self._pending.popleft()
            self.last_hud = hud
            self.status = int(hud[HUD_STATUS])
            if self.status != OK and int(hud[HUD_N_KF]) <= 5:
                self.reset()
                return

    # ------------------------------------------------------------------
    def _initialize(self, frame):
        cfg = self.cfg
        if not bool(self.ts.init_valid_frame):
            self.ts = init_mod.store_init_frame(self.ts, frame)
            return
        if int(frame.n) <= cfg.tracking.min_init_kps:
            self.ts = self.ts._replace(
                init_valid_frame=torch.tensor(False, device=self.device))
            return
        match = init_mod.match_for_init(self.ts, frame, cfg)
        if int(match.n) < cfg.tracking.min_init_matches:
            self.ts = init_mod.store_init_frame(self.ts, frame)
            return
        sets = twoview.sample_sets(self.gen, match.idx >= 0,
                                   cfg.init.ransac_iters)
        state, ts, ok = init_mod.create_mono_map(self.state, self.ts, frame,
                                                 match.idx, sets, cfg)
        if bool(ok):
            self.state, self.ts = state, ts
            # refine the fresh two-KF map with a global BA (Tracking.cc:686)
            k1 = int(self.state.next_kf) - 1
            self.state = ba_local.global_ba(self.state, cfg,
                                            n_outer=cfg.ba.global_ba_iters,
                                            n_cg=40)
            T1 = self.state.kf_pose[k1]
            self.ts = self.ts._replace(T=T1, last_T=T1)
            self.ts = record_traj(self.state, self.ts, frame, True)
            self.status = OK
        # on failure keep the stored first frame and retry with the next

    def reset(self):
        """Reference System/Tracking::Reset."""
        self.state = empty_map(self.cfg, self.device)
        self.ts = tracking.empty_track_state(self.cfg, self.device)
        self.status = NOT_INITIALIZED

    # ------------------------------------------------------------------
    def _traj_arrays(self):
        """Frame poses rebuilt as Tcr x (final optimized) reference-KF pose
        (reference System::SaveTrajectoryTUM)."""
        self.flush()
        traj = self.ts.traj
        ref = traj[:, 14].to(torch.int64).clamp(min=0)
        Tcw = lie.se3_compose(traj[:, 7:14], self.state.kf_pose[ref])
        Twc = lie.se3_inverse(Tcw)
        Tcw, Twc = Tcw.cpu().numpy(), Twc.cpu().numpy()
        traj = traj.cpu().numpy()
        ok = (traj[:, 15] > 0.5) & (traj[:, 14] >= 0)
        ok[self.frame_count:] = False
        t = traj[:, 16]
        return [(t[i], Tcw[i], Twc[i]) for i in np.nonzero(ok)[0]]

    def poses_twc(self) -> np.ndarray:
        recs = self._traj_arrays()
        if not recs:
            return np.zeros((0, 7))
        return np.stack([r[2] for r in recs])

    def timestamps(self) -> np.ndarray:
        return np.asarray([r[0] for r in self._traj_arrays()])

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as f:
            for t, _Tcw, Twc in self._traj_arrays():
                qw, qx, qy, qz, tx, ty, tz = Twc
                f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")
