"""The port's benchmark run: tracked frames/s on the bench's synthetic
sequences, through the session (the counterpart of the root `bench.py`).

    python -m orb_slam2_tpu_torch.bench [--device cpu]
    tpu-slam-torch bench [--device cpu]

Runs the mono bench run (the default SLAMConfig: 640x480, 1000 features,
the default vocabulary; the 120-frame xyz sequence, 500 points, seed 0) and
the stereo run (the same with bf = 40, 60 frames, the right eye rendered
from `right_poses`) through `SLAM`, so on the card through its captured
per-frame program, and prints ONE JSON line with bench.py's keys:
`metric` (tracked_frames_per_s_per_chip), `value` (the frames after the
first 10 over the wall time from the call of the 11th to the end of
`flush()` and a synchronisation, so the device work still queued behind
the host counts too), `unit`, `vs_baseline` (against 30 fps),
`ate_rmse_m` (scale-aligned), `tracked_frames`, `total_frames`,
`keyframes`, `map_points`, `frame_ms_p90`, `frame_ms_max` (the host's
time of each call after the first 10), `stages` (the eager step's parts
on the warm final state, median ms of 5 calls (1 with `--small`): frame
construction, tracking, a keyframe's insertion and all its integration
stages) and a `stereo` block (fps, metric ATE, frames), plus the device's
name.  `BENCH_FRAMES`, `BENCH_STEREO` (0: no stereo run) and
`BENCH_STEREO_FRAMES` set the runs as in bench.py; `BENCH_BATCH` > 1 sets
`frame_batch`; `--small` takes tests/test_e2e.py's 320x240 configuration
for the mono run instead (a quick check).

Unlike bench.py it has no watchdog and no catch-all: a failure raises and
the command exits non-zero.  It defines no cells and writes no file.
Runs on the CUDA card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from orb_slam2_tpu_torch import config, resolve_device
from orb_slam2_tpu_torch.io import evaluate, synthetic
from orb_slam2_tpu_torch.pipeline import system, tracking
from orb_slam2_tpu_torch.pipeline.system import SLAM

WARM = 10          # frames before the timed span
STAGE_REPS = 5     # timed calls of each stage


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_times(slam: SLAM, seq, reps: int = STAGE_REPS) -> dict:
    """Median ms of the eager step's parts on the session's warm state
    (copies; the session is not changed): frame construction, the
    tracking step, and a keyframe's insertion with all its integration
    stages (bench.py `_stage_times`)."""
    dev, cfg = slam.device, slam.cfg
    img = torch.as_tensor(np.asarray(seq.images[-1], np.float32), device=dev)
    fid, t_last = slam.frame_count, float(seq.timestamps[-1])
    track = tracking.build_track_step(cfg)

    def timed(fn):
        fn()
        out = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    frame = slam._frame_fn(img, fid, t_last)

    def keyframe():
        st, ts, cur_pids, _ = track(slam.state, slam.ts, frame)
        st, ts = system.insert_kf(st, ts, frame, cur_pids, cfg)
        for _ in range(system.n_stages(cfg)):
            st, ts = system.mapping_stage(st, ts, cfg)

    return {"extract_ms": round(timed(lambda: slam._frame_fn(
                img, fid, t_last)), 2),
            "track_ms": round(timed(lambda: track(slam.state, slam.ts,
                                                  frame)), 2),
            "keyframe_ms": round(timed(keyframe), 2)}


def _frame_ms(slam: SLAM) -> np.ndarray:
    return np.asarray(slam.timings[WARM:]) * 1e3


def _drive(slam: SLAM, feed, n_frames: int) -> float:
    """Feed frames 0 .. n_frames - 1 and flush; frames/s over the frames
    after the first WARM: their count over the wall time from the call of
    frame WARM (the card idle) to the end of `flush()` and a
    synchronisation."""
    t0 = None
    for f in range(n_frames):
        if f == WARM:
            _sync(slam.device)
            t0 = time.perf_counter()
        feed(f)
    slam.flush()
    _sync(slam.device)
    if t0 is None:
        return 0.0
    return (n_frames - WARM) / (time.perf_counter() - t0)


def run_mono(cfg, n_frames: int, device):
    seq = synthetic.generate(cfg.camera, n_frames=n_frames, n_points=500,
                             trajectory="xyz", seed=0)
    slam = SLAM(cfg, device=device)
    fps = _drive(slam, lambda f: slam.track_mono(seq.images[f],
                                                 seq.timestamps[f]), n_frames)
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    ate = (evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=True)
           if len(ie) >= 10 else float("nan"))
    return slam, seq, fps, ate, len(ie)


def run_stereo(n_frames: int, device, batch: int = 1):
    cfg = config.SLAMConfig(sensor=config.STEREO,
                            camera=config.CameraConfig(bf=40.0),
                            frame_batch=batch)
    seq = synthetic.generate(cfg.camera, n_frames=n_frames, n_points=500,
                             trajectory="xyz", seed=0)
    right = synthetic.generate(
        cfg.camera, n_frames=n_frames, n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(seq.poses_twc,
                                             cfg.camera.baseline)).images
    slam = SLAM(cfg, device=device)
    fps = _drive(slam, lambda f: slam.track_stereo(
        seq.images[f], right[f], seq.timestamps[f]), n_frames)
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    ate = (evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=False)
           if len(ie) >= 10 else float("nan"))
    return fps, ate, len(ie)


def _r(x, nd):
    return round(float(x), nd) if x == x else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tpu-slam-torch bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--small", action="store_true",
                    help="tests/test_e2e.py's 320x240 mono configuration "
                    "(a quick check, not the benchmark)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_frames = int(os.environ.get("BENCH_FRAMES", "120"))
    batch = max(int(os.environ.get("BENCH_BATCH", "1")), 1)
    cfg = config.SLAMConfig(frame_batch=batch)
    if args.small:
        cfg = cfg.replace(
            camera=config.CameraConfig(fx=200.0, fy=200.0, cx=160.0,
                                       cy=120.0, width=320, height=240),
            orb=config.ORBConfig(n_features=500, max_keypoints=512),
            cap=config.Capacity(max_keyframes=96, max_points=6144,
                                max_obs_per_kf=512, max_frames=512,
                                local_ba_points=2048))
    slam, seq, fps, ate, n_tracked = run_mono(cfg, n_frames, device)
    times = _frame_ms(slam)
    out = {
        "metric": "tracked_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "ate_rmse_m": _r(ate, 4),
        "tracked_frames": int(n_tracked),
        "total_frames": n_frames,
        "keyframes": int(slam.state.n_kf),
        "map_points": int(slam.state.n_mp),
        "frame_ms_max": round(float(times.max()), 1) if len(times) else None,
        "frame_ms_p90": round(float(np.percentile(times, 90)), 1)
        if len(times) else None,
        "stages": stage_times(slam, seq,
                              1 if args.small else STAGE_REPS),
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else str(device),
        "captured": slam.capture,
    }
    if os.environ.get("BENCH_STEREO", "1") != "0":
        n_st = int(os.environ.get("BENCH_STEREO_FRAMES", "60"))
        sfps, sate, sn = run_stereo(n_st, device, batch)
        out["stereo"] = {"fps": round(sfps, 2),
                         "vs_baseline": round(sfps / 30.0, 3),
                         "ate_rmse_m": _r(sate, 4),
                         "tracked_frames": int(sn), "total_frames": n_st}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
