"""Where a dp step's device time goes, by phase; and the captured step's
times, to hold one tree against another in one call.

    python3 -m orb_slam2_tpu_torch.dp_profile [--seqs NPZ] [--out PATH]

The dp step (`distributed/dp.py`) marks its phases with host ranges
(`dp.PHASE`): `extract`, the S-image frame function (one atlas program,
one FAST launch over 8·S planes); `track`, the track step
(`tracking.build_track_step`); `insert`, `system.insert_kf` (a keyframe
and its depth points); `stage`, `system.mapping_stage` (one integration
stage).  `split_run` runs the eager `DPProgram` and profiles each step
from WARM to the end under torch.profiler, host and device activity, and
`charge` charges every device kernel, copy and fill to the phase whose
range launched it (`other`: the rest of the step, the branches'
predicates and the HUD).  `chip_smoke.py` phase 18 prints that split at
every S.

The command renders the RGB-D xyz sequences of seeds 0 to 7 (640x480,
the bench's 500 points, bf 40, FRAMES frames: phase 18's inputs; `--seqs`
keeps them in an npz, read when it exists), and at each S of SIZES times
the captured program over steps WARM to FRAMES - 1 (`timed_run`: step ms
by CUDA events, wall ms a step, frames/s, the host's ms in a step call,
peak memory) in a process that has run no torch.profiler trace: after
one, CUPTI stays attached and each graph launch blocks the host until
the graph has nearly run.  It needs only the dp module's `DPProgram`, so
a copy of this file and of `frame_profile.py` in an older checkout that
has one times that tree.  Prints one JSON object as its last line (also
written to `--out`).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import multiprocessing
import os
import statistics
import subprocess
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from orb_slam2_tpu_torch import frame_profile

# phase 18's dp runs: the sequence counts, the frames of each sequence,
# and the first step of the measured window (the captured program's first
# step captures it)
SIZES, FRAMES, WARM = (1, 2, 4, 8), 48, 8
PHASES = ("extract", "track", "insert", "stage")
OTHER = "other"


def charge(prof, label: str, top=None) -> dict:
    """{phase: [device us, device events]} of a finished trace whose phase
    ranges are named `label` + phase (`dp.PHASE`), with `OTHER` for the
    events launched outside the ranges and "unattributed" for those whose
    launch the trace does not show.  The ranges' own device-side spans are
    not events of their own.  With a dict `top`, adds each event's us to
    top[phase][name]."""
    dev_t = torch.autograd.DeviceType.CUDA
    ranges, runtime, ops, device = [], {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == dev_t:
            if not e.name().startswith(label):
                device.append(e)
            continue
        name = e.name()
        if name.startswith(label):
            ranges.append((e.start_ns(), e.end_ns(), name[len(label):]))
        elif name.startswith("cu"):       # the runtime's launches, copies
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = {p: [0.0, 0] for p in PHASES + (OTHER, "unattributed")}
    for e in device:
        t = runtime.get(e.correlation_id())
        if t is None:
            t = ops.get(e.linked_correlation_id())
        if t is None:
            phase = "unattributed"
        else:
            i = bisect.bisect_right(starts, t) - 1
            phase = ranges[i][2] if i >= 0 and t <= ranges[i][1] else OTHER
        out[phase][0] += e.duration_ns() / 1e3
        out[phase][1] += 1
        if top is not None:
            names = top.setdefault(phase, {})
            names[e.name()] = names.get(e.name(), 0.0) + e.duration_ns() / 1e3
    return out


def split_run(dp, cfg, imgs, depths, stamps, warm: int = WARM, guard=None):
    """init and the steps of an eager `DPProgram` over the stacked inputs
    (images, depths [S, F, H, W], timestamps [S, F] on the card), steps
    `warm` to F - 1 each under a profiler trace of its own, charged by
    phase.  Returns {"phases": {phase: {"device_ms", "kernels"}} a step,
    "device_ms", "kernels" a step, "top_ms", "prog"}."""
    from torch.profiler import ProfilerActivity, profile
    S, F = imgs.shape[:2]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    guard = guard or contextlib.nullcontext
    prog = dp.DPProgram(cfg, S, imgs.device, capture=False)
    prog.init(imgs[:, 0], depths[:, 0])
    step = lambda f: prog.step(imgs[:, f], depths[:, f], f, stamps[:, f])
    with guard():
        for f in range(1, warm):
            step(f)
    tot, top = {}, {}
    for f in range(warm, F):
        with profile(activities=acts) as prof:
            with guard():
                step(f)
            torch.cuda.synchronize()
        for k, (us, n) in charge(prof, dp.PHASE, top).items():
            a = tot.setdefault(k, [0.0, 0])
            a[0] += us
            a[1] += n
    n = F - warm
    phases = {k: {"device_ms": us / 1e3 / n, "kernels": c / n}
              for k, (us, c) in tot.items()}
    top = {k: {name: us / 1e3 / n for name, us in sorted(
        v.items(), key=lambda kv: -kv[1])[:3]} for k, v in top.items()}
    return {"phases": phases,
            "device_ms": sum(p["device_ms"] for p in phases.values()),
            "kernels": sum(p["kernels"] for p in phases.values()),
            "top_ms": top, "prog": prog}


def timed_run(dp, cfg, imgs, depths, stamps, warm: int = WARM) -> dict:
    """The captured `DPProgram` over the same inputs, steps `warm` to
    F - 1 timed (`frame_profile.time_steps`).  Returns step ms (median,
    p90, max), wall ms a step, the host's median ms in a step call, total
    frames/s, peak GiB, capture s."""
    S, F = imgs.shape[:2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prog = dp.DPProgram(cfg, S, imgs.device, capture=True)
    prog.init(imgs[:, 0], depths[:, 0])
    step = lambda f: prog.step(imgs[:, f], depths[:, f], f, stamps[:, f])
    for f in range(1, warm):
        step(f)
    t = frame_profile.time_steps(step, range(warm, F))
    ms = t["step_ms"]
    return {"step_ms_median": statistics.median(ms),
            "step_ms_p90": statistics.quantiles(ms, n=10)[8],
            "step_ms_max": max(ms), "wall_ms": t["wall_ms"],
            "host_call_ms_median": statistics.median(t["host_ms"]),
            "frames_per_s": S * 1e3 / t["wall_ms"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "capture_s": prog.capture_s,
            "graph_replays": prog.graph_replays, "steps": prog.steps}


def split_line(S: int, r: dict) -> str:
    """One run's split as a line of text."""
    parts = ", ".join(
        f"{k} {v['device_ms']:.3f} ms / {v['kernels']:.1f}"
        for k, v in r["phases"].items() if v["kernels"] or k != "unattributed")
    return (f"dp S={S} eager, by phase (device ms / kernels a step): {parts}; "
            f"total {r['device_ms']:.3f} ms / {r['kernels']:.1f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--seqs", help="an npz of the rendered sequences: "
                    "read when it exists, else written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_profile needs a CUDA card")
    from orb_slam2_tpu_torch import config
    from orb_slam2_tpu_torch.distributed import dp
    from orb_slam2_tpu_torch.io import synthetic
    cfg = config.SLAMConfig(sensor=config.RGBD,
                            camera=config.CameraConfig(bf=40.0))
    n_seq = max(SIZES)
    keys = ("images", "depths", "timestamps")
    if args.seqs and os.path.exists(args.seqs):
        with np.load(args.seqs) as z:
            data = {k: z[k] for k in keys}
    else:
        with ProcessPoolExecutor(min(n_seq, 4), mp_context=multiprocessing.
                                 get_context("spawn")) as ex:
            seqs = [ex.submit(synthetic.generate, cfg.camera,
                              n_frames=FRAMES, n_points=500,
                              trajectory="xyz", seed=s)
                    for s in range(n_seq)]
            seqs = [f.result() for f in seqs]
        data = {k: np.stack([np.asarray(getattr(q, k), np.float32)
                             for q in seqs]) for k in keys}
        if args.seqs:
            np.savez(args.seqs, **data)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    print(f"card: {card}", flush=True)
    out = {"card": card, "frames": FRAMES, "warm": WARM,
           "torch": torch.__version__, "sizes": {}}
    for S in SIZES:
        t = timed_run(dp, cfg, *(torch.as_tensor(data[k][:S]).cuda()
                                 for k in keys))
        print(f"dp S={S} captured: step ms median {t['step_ms_median']:.3f} "
              f"p90 {t['step_ms_p90']:.3f} max {t['step_ms_max']:.3f}, wall "
              f"{t['wall_ms']:.3f} ms a step, {t['frames_per_s']:.2f} "
              f"frames/s; host ms a step call median "
              f"{t['host_call_ms_median']:.3f}; peak {t['peak_gib']:.3f} "
              "GiB", flush=True)
        out["sizes"][S] = {"captured": t}
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
