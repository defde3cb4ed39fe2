"""Where a monocular frame's time goes on the card.

    python3 -m orb_slam2_tpu_torch.frame_profile [--frames 80] [--window 20]
                                                  [--out PATH]

Runs `SLAM` at the default configuration (640x480, 1000 features) on the
bench sequence (xyz trajectory, 500 points, seed 0) on CUDA, and reports:

* over one window of `--window` frames, host wall time per phase of the
  per-frame step (extraction, tracking, keyframe insertion, each
  keyframe-integration stage), each phase timed between two
  `torch.cuda.synchronize()` calls, so a phase's number includes its
  device work;
* over the next window, a `torch.profiler` trace: device time by kernel
  and kernel launches per frame; the device's idle share is one minus that
  device time over the first window's wall time.

The phases are timed by wrapping the step's building blocks, so the
session runs its own code unchanged.  Prints one JSON object as its last
line and writes it to `--out` when given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from collections import defaultdict

import torch

from orb_slam2_tpu_torch import config
from orb_slam2_tpu_torch.io import synthetic
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import system, tracking

STAGE_NAMES = ["triangulate", "fuse", "local_ba", "local_ba", "local_ba",
               "cull"]


def _timed(name, fn, clock):
    def wrapped(*args, **kwargs):
        label = name(*args) if callable(name) else name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        clock[label].append(time.perf_counter() - t0)
        return out
    return wrapped


def _instrument(clock):
    """Wrap the per-frame step's building blocks with phase timers."""
    build_frame = frame_mod.build_mono_frame_fn
    build_track = tracking.build_track_step
    frame_mod.build_mono_frame_fn = lambda cfg, device=None: _timed(
        "extract", build_frame(cfg, device), clock)
    tracking.build_track_step = lambda cfg: _timed(
        "track", build_track(cfg), clock)
    system.insert_kf = _timed("insert_kf", system.insert_kf, clock)
    stage_of = lambda state, ts, cfg: "map_" + STAGE_NAMES[
        min(int(ts.map_stage), len(STAGE_NAMES) - 1)]
    system.mapping_stage = _timed(stage_of, system.mapping_stage, clock)


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA card")

    cfg = config.SLAMConfig()
    seq = synthetic.generate(cfg.camera, n_frames=args.frames, n_points=500,
                             trajectory="xyz", seed=0)
    clock = defaultdict(list)
    _instrument(clock)
    slam = system.SLAM(cfg, device="cuda")
    n = args.window
    warm = args.frames - 2 * n
    if warm < 10:
        raise SystemExit("--frames must leave 10 warm-up frames before the "
                         "two windows")
    for f in range(warm):
        slam.track_mono(seq.images[f], seq.timestamps[f])

    # window 1: phase timers only
    torch.cuda.synchronize()
    clock.clear()
    t0 = time.perf_counter()
    for f in range(warm, warm + n):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    phases = {k: list(v) for k, v in clock.items()}

    # window 2: the profiler (its own overhead inflates the wall time)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for f in range(warm + n, warm + 2 * n):
            slam.track_mono(seq.images[f], seq.timestamps[f])
        torch.cuda.synchronize()
    prof_wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(_device_time_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    dev_ms = dev_us / 1e3 / n
    out = {
        "device": torch.cuda.get_device_name(0),
        "frames_per_window": n,
        # window 1: phase timers (two synchronisations per phase)
        "wall_ms_per_frame": wall_s * 1e3 / n,
        "phase_ms_per_frame": {k: sum(v) * 1e3 / n for k, v in phases.items()},
        "phase_calls": {k: len(v) for k, v in phases.items()},
        "phase_ms_median_per_call": {k: statistics.median(v) * 1e3
                                     for k, v in phases.items()},
        # window 2: the profiler
        "profiled_wall_ms_per_frame": prof_wall_s * 1e3 / n,
        "device_ms_per_frame": dev_ms,
        "kernel_launches_per_frame": launches / n,
        # device time over window 1's wall time (the profiler's own host
        # overhead would otherwise count as idle)
        "device_idle_share": 1.0 - dev_ms / (wall_s * 1e3 / n),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms_per_frame": _device_time_us(e) / 1e3 / n}
                        for e in top],
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
