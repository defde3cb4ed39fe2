#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and nvcc.  Phases,
each of which fails the run when it fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: compile csrc/fast_nms.cu with nvcc (sm_90a) and load it;
  3. kernel: the FAST-9+NMS kernel against its plain PyTorch version on the
     card, bit-exact, at the 8 pyramid-level shapes of a 640x480 frame plus
     a 70x128 remainder case; warm CUDA-event timings of both (median of
     30 calls) and the kernel's own device time (torch.profiler); then one
     frame through the extractor on the card and on the CPU;
  4. main path: monocular SLAM at the default SLAMConfig (640x480, 1000
     features, 32768 map points, 512 keyframes) on the bench sequence (120
     frames, 500 points, xyz trajectory, seed 0), through `SLAM.track_mono`;
     checks tracking rate, scale-aligned ATE, that the state lives on the
     card and that every extracted frame went through the kernel;
  5. determinism: two fresh 30-frame runs give bit-identical poses.

Prints the card's name and power limit and a JSON line describing every
ported kernel, then, as the last line, {"ok": true, "device": {...}}.  Exits
non-zero without that line when there is no CUDA device or the package is
missing.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST-9 + NMS arithmetic per pixel: 16 differences, 16 rotations x (2 x 8
# min + 2 max), the final 2 max, 8 NMS max + 1 compare
FAST_OPS_PER_PX = 16 + 16 * 18 + 2 + 9
# bytes per pixel: read the image once (4 B), write nms + raw (8 B)
FAST_BYTES_PER_PX = 12

ATE_GATE_M = 0.02          # test_mono_ate_gate (tests/test_e2e.py)
TRACKED_MIN_FRAC = 0.8
N_FRAMES = 120
DET_FRAMES = 30


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median over `reps` of one call's time between two CUDA events (the
    device time plus any gap the host leaves while launching)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def device_ms(fn, name: str, reps: int = 20):
    """Device time of one launch of the kernel `name` (torch.profiler, mean
    over `reps` launches), or None when the trace holds no device time.
    CUDA events around a call also hold the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if name in e.key:
            us += float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
    return us / reps / 1e3 if us > 0 else None


def check_kernel(fast_cuda, shapes):
    """Bit-exact kernel vs plain version at each shape; timings per shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (H, W) in shapes:
        img = torch.rand((H, W), generator=gen, device="cuda") * 255.0
        nms, raw = fast_cuda.fast_nms_cuda(img)
        pn, pr = fast_cuda.fast_nms_raw_plain(img)
        torch.cuda.synchronize()
        err = max(float((nms - pn).abs().max()), float((raw - pr).abs().max()))
        exact = bool(torch.equal(nms, pn)) and bool(torch.equal(raw, pr))
        k_ms = time_ms(lambda: fast_cuda.fast_nms_cuda(img))
        p_ms = time_ms(lambda: fast_cuda.fast_nms_raw_plain(img))
        d_ms = device_ms(lambda: fast_cuda.fast_nms_cuda(img),
                         "fast_nms_kernel")
        bytes_s = H * W * FAST_BYTES_PER_PX / PEAK_BYTES_PER_S
        ops_s = H * W * FAST_OPS_PER_PX / PEAK_F32_OPS_PER_S
        bound_s = max(bytes_s, ops_s)
        rows.append(dict(shape=(H, W), exact=exact, err=err, ms=k_ms,
                         device_ms=d_ms, plain_ms=p_ms,
                         bound_ms=bound_s * 1e3,
                         bound_by="bytes" if bytes_s >= ops_s
                         else "operations"))
        dev = "not measured" if d_ms is None else f"{d_ms:.5f} ms"
        print(f"  fast_nms {H}x{W}: exact={exact} max_abs_err={err} "
              f"call {k_ms:.4f} ms (kernel on the device {dev})  "
              f"plain {p_ms:.4f} ms  bound {bound_s * 1e3:.5f} ms",
              flush=True)
    return rows


def run_slam(SLAM, cfg, seq, n):
    slam = SLAM(cfg, device="cuda")
    for f in range(n):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return slam


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    try:
        from orb_slam2_tpu_torch import config
        from orb_slam2_tpu_torch.frontend import fast_cuda, pyramid
        from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
        from orb_slam2_tpu_torch.io import evaluate, synthetic
        from orb_slam2_tpu_torch.pipeline.system import SLAM
    except ImportError as e:
        return fail(f"the orb_slam2_tpu_torch package is missing ({e}); run "
                    "from the repository root")
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.abspath(config.__file__))
    if os.path.dirname(pkg) != here:
        return fail(f"orb_slam2_tpu_torch found at {pkg}, not beside this "
                    "script")
    if "jax" in sys.modules:
        return fail("jax was imported")

    # 1. environment
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = fast_cuda.build(verbose=True)
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel vs plain version, at the main path's shapes
    cfg = config.SLAMConfig()
    cam = cfg.camera
    levels = pyramid.level_shapes(cam.height, cam.width, cfg.orb.n_levels,
                                  cfg.orb.scale_factor)
    rows = check_kernel(fast_cuda, levels + [(70, 128)])
    if not all(r["exact"] for r in rows):
        return fail("fast_nms kernel disagrees with its plain version")
    frame_rows = rows[:len(levels)]
    if all(r["device_ms"] is not None for r in frame_rows):
        print(f"fast_nms, one frame's 8 levels: calls "
              f"{sum(r['ms'] for r in frame_rows):.4f} ms, kernels on the "
              f"device {sum(r['device_ms'] for r in frame_rows):.5f} ms, "
              f"bound {sum(r['bound_ms'] for r in frame_rows):.5f} ms",
              flush=True)

    seq = synthetic.generate(cam, n_frames=N_FRAMES, n_points=500,
                             trajectory="xyz", seed=0)
    ext_gpu = build_atlas_extractor(cfg.orb, cam.height, cam.width, "cuda")
    ext_cpu = build_atlas_extractor(cfg.orb, cam.height, cam.width, "cpu")
    img0 = torch.as_tensor(seq.images[0])
    fg, fc = ext_gpu(img0.cuda()), ext_cpu(img0)
    same = ((fg.valid.cpu() == fc.valid) & (fg.octave.cpu() == fc.octave) &
            ((fg.uv.cpu() - fc.uv).abs().amax(-1) <= 1e-3))
    print(f"extractor card vs CPU: {float(same.float().mean()):.4f} of "
          f"{same.numel()} slots agree", flush=True)
    if float(same.float().mean()) < 0.99:
        return fail("extractor on the card disagrees with the CPU run")

    # 4. main path; counts zeroed just before, read just after
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    slam = run_slam(SLAM, cfg, seq, N_FRAMES)
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    extracted = slam.frame_count
    if launches != cfg.orb.n_levels * extracted:
        return fail(f"fast_nms launches {launches} != "
                    f"{cfg.orb.n_levels} x {extracted} frames")
    off_card = [f for st in (slam.state, slam.ts) for f, v in
                zip(st._fields, st) if v.device.type != "cuda"]
    if off_card:
        return fail(f"state tensors off the card: {off_card}")
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    if len(ie) < TRACKED_MIN_FRAC * N_FRAMES:
        return fail(f"tracked {len(ie)}/{N_FRAMES} frames")
    ate = evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=True)
    if not ate <= ATE_GATE_M:
        return fail(f"ATE {ate} m > {ATE_GATE_M} m")
    times = [t * 1e3 for t in slam.timings[10:]]
    qs = statistics.quantiles(times, n=10)
    print(f"main path on {name} ({card}): {N_FRAMES} frames in {wall:.2f} s, "
          f"steady fps {1e3 / statistics.mean(times):.3f}, frame ms "
          f"p50 {statistics.median(times):.2f} p90 {qs[8]:.2f} "
          f"max {max(times):.2f}; tracked {len(ie)}/{N_FRAMES}, keyframes "
          f"{int(slam.state.n_kf)}, map points {int(slam.state.n_mp)}, "
          f"ATE {ate:.6f} m, fast_nms launches {launches}", flush=True)

    # 5. determinism
    a = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
    b = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
    if a.shape != b.shape or not (a == b).all():
        return fail("two identical runs gave different trajectories")
    print(f"determinism: two {DET_FRAMES}-frame runs bit-identical "
          f"({a.shape[0]} poses)", flush=True)

    kernels = [{
        "name": "fast_nms", "route": "cuda",
        "source": "orb_slam2_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orb_slam2_tpu/frontend/pallas_fast.py:42",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        # one frame's worth of launches: the 8 pyramid levels
        "ms": sum(r["ms"] for r in frame_rows),
        "plain_ms": sum(r["plain_ms"] for r in frame_rows),
        "bound_ms": sum(r["bound_ms"] for r in frame_rows),
        "bound_by": frame_rows[0]["bound_by"],
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
