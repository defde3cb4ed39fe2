"""Where a frame's time goes on the card.

    python3 -m orb_slam2_tpu_torch.frame_profile [--sensor mono|stereo|rgbd]
        [--preset bench|kitti] [--frames 80] [--window 20] [--out PATH]

Runs `SLAM` on CUDA at the bench's configuration for the sensor (mono: the
default SLAMConfig, 640x480, 1000 features; stereo and RGB-D: the same with
bf = 40, as bench.py `_run_stereo`) on the bench sequence (xyz trajectory,
500 points, seed 0; the right eye rendered from `right_poses`, the depth
maps the renderer's), or with `--preset kitti` the KITTI 00-02 stereo
preset (`kitti_config`: 1241x376, bf 386.1, 2000 features, 2048 keyframes,
131,072 points) on the room rendered at that camera along the forward
trajectory, and reports:

* over one window of `--window` frames, host wall time per phase of the
  eager per-frame step (`frame`: the whole frame construction, of which
  `orb` is the ORB extraction and, for stereo, `stereo_sad` the SAD
  refinement; tracking; keyframe insertion, of which `depth_points` is
  `create_depth_points` for stereo/RGB-D; each keyframe-integration
  stage), each phase timed between two `torch.cuda.synchronize()` calls,
  so a phase's number includes its device work;
* over the next window, a `torch.profiler` trace: device time by kernel
  and kernel launches per frame; the device's idle share is one minus that
  device time over the first window's wall time;
* every phase call of the warm-up frames before the windows, each: a
  stereo or RGB-D session makes its keyframes early, so its insertions and
  integration stages may fall there.

The phases are timed by wrapping the step's building blocks, so the
session runs its own code unchanged; the phase timers need the eager step
(`SLAM(..., capture=False)`: a timer's synchronisation cannot be
captured).  Before them, graph mode (`"graph"` in the output) runs the
session as users do, its per-frame program captured as a CUDA graph and
replayed: the same two windows give the wall ms a frame (host clock, one
synchronisation at each end), the frame ms quantiles, the host ms a frame
of the dispatch, of the replay call within it and of the HUD reactions,
the device ms a frame, the kernels the device ran a frame and the graph
launches a frame, and the idle share of the replayed program.  Prints one
JSON object as its last line and writes it to `--out` when given.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from orb_slam2_tpu_torch import config
from orb_slam2_tpu_torch.io import synthetic
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import mapping, system, tracking

STAGE_NAMES = ["triangulate", "fuse", "local_ba", "local_ba", "local_ba",
               "cull"]
SENSORS = {"mono": config.MONOCULAR, "stereo": config.STEREO,
           "rgbd": config.RGBD}


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
    """Wrap the per-frame step's building blocks with phase timers (the
    nested ones, `orb` and `stereo_sad` in `frame`, `depth_points` in
    `insert_kf`, are also counted in their parent)."""
    build_frame = system.build_frame_fn
    build_extractor = frame_mod.build_extractor
    build_track = tracking.build_track_step
    system.build_frame_fn = lambda cfg, device=None: _timed(
        "frame", build_frame(cfg, device), clock)
    frame_mod.build_extractor = lambda *a, **kw: _timed(
        "orb", build_extractor(*a, **kw), clock)
    frame_mod._sad_subpixel_atlas = _timed(
        "stereo_sad", frame_mod._sad_subpixel_atlas, clock)
    tracking.build_track_step = lambda cfg: _timed(
        "track", build_track(cfg), clock)
    system.insert_kf = _timed("insert_kf", system.insert_kf, clock)
    mapping.create_depth_points = _timed(
        "depth_points", mapping.create_depth_points, clock)
    stage_of = lambda state, ts, cfg: "map_" + STAGE_NAMES[
        min(int(ts.map_stage), len(STAGE_NAMES) - 1)]
    system.mapping_stage = _timed(stage_of, system.mapping_stage, clock)


def device_time_us(evt) -> float:
    """The device time of a torch.profiler event, in us."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def time_steps(step, frames, guard=contextlib.nullcontext) -> dict:
    """`step(f)` over `frames`, timed three ways: "wall_ms" a step over
    the window (host clock, one synchronisation at each end), "step_ms"
    each step's device span (a CUDA event after each step, no
    synchronisation inside) and "host_ms" each step call's host time;
    `guard()` is entered around the steps, not the synchronisations."""
    frames = list(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_ms = []
    with guard():
        evs = [torch.cuda.Event(enable_timing=True)]
        evs[0].record()
        for f in frames:
            h0 = time.perf_counter()
            step(f)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            evs.append(torch.cuda.Event(enable_timing=True))
            evs[-1].record()
    torch.cuda.synchronize()
    return {"wall_ms": (time.perf_counter() - t0) * 1e3 / len(frames),
            "step_ms": [a.elapsed_time(b) for a, b in zip(evs, evs[1:])],
            "host_ms": host_ms}


def wall_window(track, frames, guard=contextlib.nullcontext) -> float:
    """Wall ms a frame of `track(f)` over `frames` (`time_steps`)."""
    return time_steps(track, frames, guard)["wall_ms"]


def profile_window(track, frames, guard=contextlib.nullcontext):
    """Device ms and kernels, summed over `frames` under torch.profiler,
    the kernels' events and the wall s; `guard()` as in `wall_window`."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        with guard():
            for f in frames:
                track(f)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(device_time_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels), kernels,
            time.perf_counter() - t0)


def _host_timed(fn, acc, name):
    """`fn`, its host time (no synchronisation) added to acc[name]."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        acc[name] += time.perf_counter() - t0
        return out
    return wrapped


def _feeder(slam, sensor, seq, second):
    return {config.MONOCULAR: lambda f: slam.track_mono(
                seq.images[f], seq.timestamps[f]),
            config.STEREO: lambda f: slam.track_stereo(
                seq.images[f], second[f], seq.timestamps[f]),
            config.RGBD: lambda f: slam.track_rgbd(
                seq.images[f], second[f], seq.timestamps[f])}[sensor]


def graph_mode(cfg, sensor, seq, second, warm: int, n: int) -> dict:
    """The session's captured program over the same windows: wall ms a
    frame, device ms a frame, idle share, kernels and graph launches a
    frame."""
    slam = system.SLAM(cfg, device="cuda")
    track = _feeder(slam, sensor, seq, second)
    for f in range(warm):
        track(f)
    # host time of the dispatch (staging copies, the replay, the HUD
    # copy), of the replay call alone and of the HUD reactions (reading
    # the HUD `hud_lag` frames late, waiting for it when the card is
    # behind)
    host = defaultdict(float)
    for name in ("_dispatch_batch", "_run_program", "_drain"):
        setattr(slam, name, _host_timed(getattr(slam, name), host, name))
    r0 = slam.graph_replays
    wall_ms = wall_window(track, range(warm, warm + n))
    host_ms = {k: v * 1e3 / n for k, v in host.items()}
    times = [t * 1e3 for t in slam.timings[warm:warm + n]]
    replays = slam.graph_replays - r0
    dev_ms, n_kernels, _, _ = profile_window(track,
                                             range(warm + n, warm + 2 * n))
    qs = statistics.quantiles(times, n=10)
    out = {"captured": slam.capture,
           "wall_ms_per_frame": wall_ms,
           "frame_ms_p50": statistics.median(times), "frame_ms_p90": qs[8],
           "frame_ms_max": max(times),
           "device_ms_per_frame": dev_ms / n,
           "device_idle_share": 1.0 - dev_ms / n / wall_ms,
           "kernel_launches_per_frame": n_kernels / n,
           "graph_launches_per_frame": replays / n,
           "host_ms_per_frame": {"dispatch": host_ms["_dispatch_batch"],
                                 "replay": host_ms["_run_program"],
                                 "hud_and_reactions": host_ms["_drain"]}}
    del slam
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sensor", choices=list(SENSORS), default="mono")
    ap.add_argument("--preset", choices=["bench", "kitti"], default="bench")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA card")

    sensor = SENSORS[args.sensor]
    trajectory = "xyz"
    if args.preset == "kitti":
        if sensor != config.STEREO:
            raise SystemExit("--preset kitti is a stereo preset")
        cfg, trajectory = config.kitti_config(), "forward"
    elif sensor == config.MONOCULAR:
        cfg = config.SLAMConfig()
    else:
        cfg = config.SLAMConfig(sensor=sensor,
                                camera=config.CameraConfig(bf=40.0))
    seq = synthetic.generate(cfg.camera, n_frames=args.frames, n_points=500,
                             trajectory=trajectory, seed=0)
    if sensor == config.STEREO:
        second = synthetic.generate(
            cfg.camera, n_frames=args.frames, n_points=4,
            trajectory=trajectory, seed=0,
            poses_override=synthetic.right_poses(
                seq.poses_twc, cfg.camera.baseline)).images
    else:
        second = seq.depths
    n = args.window
    warm = args.frames - 2 * n
    if warm < 10:
        raise SystemExit("--frames must leave 10 warm-up frames before the "
                         "two windows")
    graph = graph_mode(cfg, sensor, seq, second, warm, n)
    clock = defaultdict(list)
    _instrument(clock)
    slam = system.SLAM(cfg, device="cuda", capture=False)
    track = _feeder(slam, sensor, seq, second)
    for f in range(warm):
        track(f)

    # window 1: phase timers only
    torch.cuda.synchronize()
    # every timed call of the warm-up frames, kept: a stereo or RGB-D run
    # makes its keyframes (and their integration stages) early
    warm_calls = {k: [t * 1e3 for t in v] for k, v in clock.items()}
    clock.clear()
    wall_ms = wall_window(track, range(warm, warm + n))
    phases = {k: list(v) for k, v in clock.items()}

    # window 2: the profiler (its own overhead inflates the wall time)
    dev_ms, launches, kernels, prof_wall_s = profile_window(
        track, range(warm + n, warm + 2 * n))
    top = sorted(kernels, key=device_time_us, reverse=True)[:12]
    dev_ms = dev_ms / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {
        "device": torch.cuda.get_device_name(0),
        # the card's name and power limit, as nvidia-smi gives them
        "card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else None,
        "sensor": args.sensor,
        "preset": args.preset,
        "frames_per_window": n,
        # window 1: phase timers (two synchronisations per phase)
        "wall_ms_per_frame": wall_ms,
        "phase_ms_per_frame": {k: sum(v) * 1e3 / n for k, v in phases.items()},
        "phase_calls": {k: len(v) for k, v in phases.items()},
        "phase_ms_median_per_call": {k: statistics.median(v) * 1e3
                                     for k, v in phases.items()},
        # the warm-up frames' calls, each (its first calls include
        # first-use costs)
        "warmup_phase_ms_each_call": warm_calls,
        # window 2: the profiler
        "profiled_wall_ms_per_frame": prof_wall_s * 1e3 / n,
        "device_ms_per_frame": dev_ms,
        "kernel_launches_per_frame": launches / n,
        # device time over window 1's wall time (the profiler's own host
        # overhead would otherwise count as idle)
        "device_idle_share": 1.0 - dev_ms / wall_ms,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms_per_frame": device_time_us(e) / 1e3 / n}
                        for e in top],
        # the session's own path: the captured program, replayed
        "graph": graph,
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
