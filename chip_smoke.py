#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and nvcc.  Phases,
each of which fails the run when it fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: compile csrc/fast_nms.cu and csrc/pose_lm.cu with nvcc
     (sm_90a), both at once, printing ptxas's register and shared-memory
     counts;
  3. FAST kernel: the FAST-9+NMS kernel against its plain PyTorch version
     on the card, bit-exact, at the 8 pyramid-level shapes of a 640x480
     frame plus a 70x128 remainder case; CUDA-event and torch.profiler
     timings; one frame through the extractor on the card and on the CPU;
  4. pose-LM kernel: the one-launch pose LM against `pose_optimize_plain`
     on the card at N = 1024 mono, N = 1024 with a third of the rows
     stereo, N = 64, and a batch of 4 problems (seeded, ~10% outliers):
     pose within 1e-4, inlier masks agree on >= 99% of points, inlier
     counts within 2; call, device and plain times; its bound;
  5. main path: monocular SLAM at the default SLAMConfig (640x480, 1000
     features, 32768 map points, 512 keyframes) with the default vocabulary
     on, on the bench sequence (120 frames, 500 points, xyz trajectory,
     seed 0), through `SLAM.track_mono`; checks tracking rate, scale-aligned
     ATE, that the state lives on the card, BoW on every keyframe, that
     every pose LM and every extracted pyramid level went through its
     kernel;
  6. relocalisation (tests/test_e2e.py test_relocalization_recovers at the
     default config): track, blind the camera for 4 frames, revisit; must
     recover without a reset, through the pose-LM kernel;
  7. loop closing (test_e2e.py test_loop_closure_fires_and_helps, on its
     small configuration: at the default one the JAX package itself tracks
     54 of the 140 frames and never closes this loop): 1.3 revolutions,
     open and closed; the loop must fire and the closed ATE be <= 1.05 x
     the open one;
  8. determinism: two fresh 30-frame runs give bit-identical poses.

Prints the card's name and power limit and a JSON line describing every
ported kernel, then, as the last line, {"ok": true, "device": {...}}.  Exits
non-zero without that line when there is no CUDA device, the package is
missing, or any phase fails.  Imports nothing of JAX.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST-9 + NMS arithmetic per pixel: 16 differences, 16 rotations x (2 x 8
# min + 2 max), the final 2 max, 8 NMS max + 1 compare
FAST_OPS_PER_PX = 16 + 16 * 18 + 2 + 9
# bytes per pixel: read the image once (4 B), write nms + raw (8 B)
FAST_BYTES_PER_PX = 12
# pose-LM f32 operations per active point, counted from csrc/pose_lm.cu:
# an LM iteration linearizes (rotation + translation 33, projection and
# residuals 12, chi^2 6, Huber 4, 1/z 2, d proj 8, Jacobian rows 36,
# weight 2, 21 H entries x 6, 6 g entries x 6, cost 2 = 267) and
# re-evaluates the cost (33 + 12 + 6 + 4 + 2 = 57); each round's
# reclassification and the final one evaluate chi^2 (53) at every point
POSE_OPS_PER_PT_ITER = 267 + 57
POSE_OPS_PER_PT_ROUND = 53
# bytes per point: pw 12, uv 8, ur 4, inv sigma^2 4, valid 1, stereo 1 in;
# inlier flag 1 out; per problem T0, T 28 B each, n and chi^2 4 B each
POSE_BYTES_PER_PT = 31
POSE_BYTES_PER_PROBLEM = 64

ATE_GATE_M = 0.02          # test_mono_ate_gate (tests/test_e2e.py)
TRACKED_MIN_FRAC = 0.8
N_FRAMES = 120
DET_FRAMES = 30
LOOP_FRAMES = 140
# the first slice's main path (vocabulary off, pose LM in tensor ops) on the
# same card type (PERF.md, NVIDIA H100 80GB HBM3, 700 W): steady fps, frame
# ms p50 / p90 / max
FIRST_SLICE_MAIN = (2.602, 385.12, 447.67, 525.46)


class PhaseError(Exception):
    pass


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseError(msg)


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


def _dev(d_ms):
    return "not measured" if d_ms is None else f"{d_ms:.5f} ms"


def check_fast(fast_cuda, shapes):
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
        print(f"  fast_nms {H}x{W}: exact={exact} max_abs_err={err} "
              f"call {k_ms:.4f} ms (kernel on the device {_dev(d_ms)})  "
              f"plain {p_ms:.4f} ms  bound {bound_s * 1e3:.5f} ms",
              flush=True)
    return rows


def pose_problem(gen, B: int, N: int, stereo_frac: float, bf: float):
    """B seeded pose problems on the card: points 2-8 m ahead, a pose ~0.05
    off the truth, half-pixel noise, ~10% outliers, ~3% invalid rows."""
    from orb_slam2_tpu_torch.core import camera, lie
    dev = "cuda"
    K = torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    uni = lambda *s: torch.rand(s, generator=gen, device=dev)
    pw = rnd(B, N, 3) * torch.tensor([2.0, 2.0, 1.0], device=dev) + \
        torch.tensor([0.0, 0.0, 5.0], device=dev)
    T_true = lie.se3_exp(rnd(B, 6) * 0.05)
    pc = lie.se3_apply(T_true[:, None], pw)
    uv = camera.project(K, pc) + rnd(B, N, 2) * 0.5
    out = uni(B, N) < 0.1
    uv = torch.where(out[..., None], uv + rnd(B, N, 2) * 30.0, uv)
    is_st = uni(B, N) < stereo_frac
    ur = torch.where(is_st, uv[..., 0] - bf / pc[..., 2] + rnd(B, N) * 0.5,
                     -1.0)
    octv = torch.randint(0, 8, (B, N), generator=gen, device=dev)
    inv_s2 = 1.0 / (1.2 ** 2) ** octv.to(torch.float32)
    valid = uni(B, N) > 0.03
    T0 = lie.se3_compose(lie.se3_exp(rnd(B, 6) * 0.05), T_true)
    return T0, pw, uv, ur, inv_s2, valid, is_st, K


def check_pose_lm(pose_lm_cuda, pose_opt, BAConfig):
    """Kernel vs plain version at the main path's shapes; timings; bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg, bf = BAConfig(), 40.0
    rows = []
    for name, B, N, sf in (("N=1024 mono", 1, 1024, 0.0),
                           ("N=1024 third stereo", 1, 1024, 1.0 / 3.0),
                           ("N=64 mono", 1, 64, 0.0),
                           ("B=4 N=1024 mono", 4, 1024, 0.0)):
        T0, pw, uv, ur, isig, valid, st, K = pose_problem(gen, B, N, sf, bf)
        args = (T0, pw, uv, ur, isig, valid, st, K, bf, cfg)
        kT, kinl, kn, kc, kit = pose_lm_cuda.pose_lm_cuda(*args)
        kT2, kinl2, _, _, _ = pose_lm_cuda.pose_lm_cuda(*args)
        plain = [pose_opt.pose_optimize_plain(
            T0[b], pw[b], uv[b], ur[b], isig[b], valid[b], st[b], K, bf, cfg)
            for b in range(B)]
        torch.cuda.synchronize()
        pT = torch.stack([p.T for p in plain])
        err = float((kT - pT).abs().max())
        agree = float((kinl == torch.stack([p.inliers for p in plain])
                       ).float().mean())
        dn = max(abs(int(kn[b]) - int(plain[b].n_inliers)) for b in range(B))
        same = bool(torch.equal(kT, kT2)) and bool(torch.equal(kinl, kinl2))
        k_ms = time_ms(lambda: pose_lm_cuda.pose_lm_cuda(*args))
        p_ms = time_ms(lambda: [pose_opt.pose_optimize_plain(
            T0[b], pw[b], uv[b], ur[b], isig[b], valid[b], st[b], K, bf, cfg)
            for b in range(B)], reps=3, warm=1)
        d_ms = device_ms(lambda: pose_lm_cuda.pose_lm_cuda(*args),
                         "pose_lm_kernel")
        # operations this data needs: the iterations each problem ran over
        # its active points (bounded by the valid ones), plus the
        # reclassifications; and the most the 4 x 10 schedule could need
        n_act = valid.sum(1).to(torch.float64)
        iters = kit.to(torch.float64)
        rounds = cfg.pose_opt_rounds + 1
        ops = float((n_act * iters * POSE_OPS_PER_PT_ITER +
                     N * rounds * POSE_OPS_PER_PT_ROUND).sum())
        ops_max = B * N * (cfg.pose_opt_rounds * cfg.pose_opt_iters *
                           POSE_OPS_PER_PT_ITER +
                           rounds * POSE_OPS_PER_PT_ROUND)
        nbytes = B * (N * POSE_BYTES_PER_PT + POSE_BYTES_PER_PROBLEM)
        bytes_s = nbytes / PEAK_BYTES_PER_S
        ops_s = ops / PEAK_F32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        rows.append(dict(name=name, err=err, agree=agree, dn=dn, same=same,
                         ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         bound_ms=bound_ms,
                         bound_by="bytes" if bytes_s >= ops_s
                         else "operations"))
        print(f"  pose_lm {name}: max_abs_err {err:.3e}, inliers agree "
              f"{agree:.4f}, n_inliers within {dn}, two launches "
              f"bit-identical {same}; LM iterations {kit.tolist()}; call "
              f"{k_ms:.4f} ms (kernel on the device {_dev(d_ms)})  plain "
              f"{p_ms:.2f} ms  bound {bound_ms:.6f} ms ({ops:.4g} f32 ops "
              f"this data, {ops_max:.4g} at 4 x 10 iterations; {nbytes} B)",
              flush=True)
        check(err <= 1e-4, f"pose_lm {name}: pose differs by {err}")
        check(agree >= 0.99, f"pose_lm {name}: inliers agree on {agree}")
        check(dn <= 2, f"pose_lm {name}: n_inliers differ by {dn}")
        check(same, f"pose_lm {name}: two launches differ")
    return rows


def run_slam(SLAM, cfg, seq, stop, start=0, slam=None, **kw):
    slam = slam or SLAM(cfg, device="cuda", **kw)
    for f in range(start, stop):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return slam


def ate_of(slam, seq, evaluate):
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    return evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=True), \
        len(ie)


def phase_main(SLAM, cfg, seq, evaluate, counters):
    fast_cuda, pose_lm_cuda, pose_opt = counters
    # counts zeroed just before the main path, read just after
    fast_cuda.launches = pose_lm_cuda.launches = pose_opt.cuda_calls = 0
    t0 = time.perf_counter()
    slam = run_slam(SLAM, cfg, seq, N_FRAMES)
    wall = time.perf_counter() - t0
    launches = dict(fast_nms=fast_cuda.launches,
                    pose_lm=pose_lm_cuda.launches)
    calls = pose_opt.cuda_calls
    check(launches["fast_nms"] == cfg.orb.n_levels * slam.frame_count,
          f"fast_nms launches {launches['fast_nms']} != {cfg.orb.n_levels} x "
          f"{slam.frame_count} frames")
    off_card = [f for st in (slam.state, slam.ts) for f, v in
                zip(st._fields, st) if v.device.type != "cuda"]
    check(not off_card, f"state tensors off the card: {off_card}")
    ate, n = ate_of(slam, seq, evaluate)
    check(n >= TRACKED_MIN_FRAC * N_FRAMES, f"tracked {n}/{N_FRAMES} frames")
    check(ate <= ATE_GATE_M, f"ATE {ate} m > {ATE_GATE_M} m")
    kv = slam.state.kf_valid
    bow_ok = bool((slam.state.kf_bow[kv].abs().sum(1) > 0.99).all())
    check(slam.vocab is not None and bow_ok,
          "a keyframe has no BoW vector (vocabulary on)")
    # frames tracked by the per-frame step: those after the frame that
    # made the initial map's second keyframe, with a successful trajectory
    # row; each runs >= 2 pose LMs
    ok = slam.ts.traj[:slam.frame_count, 15].cpu().numpy() > 0.5
    stepped = int(ok[int(slam.state.kf_frame_id[1]) + 1:].sum())
    check(launches["pose_lm"] == calls,
          f"pose_lm launches {launches['pose_lm']} != {calls} CUDA "
          "pose_optimize calls")
    check(launches["pose_lm"] >= 2 * stepped,
          f"pose_lm launches {launches['pose_lm']} < 2 x {stepped} tracked "
          "frames")
    times = [t * 1e3 for t in slam.timings[10:]]
    qs = statistics.quantiles(times, n=10)
    print(f"main path: {N_FRAMES} frames in {wall:.2f} s, steady fps "
          f"{1e3 / statistics.mean(times):.3f}, frame ms p50 "
          f"{statistics.median(times):.2f} p90 {qs[8]:.2f} max "
          f"{max(times):.2f} (first slice, vocabulary off: fps "
          f"{FIRST_SLICE_MAIN[0]}, p50 {FIRST_SLICE_MAIN[1]} p90 "
          f"{FIRST_SLICE_MAIN[2]} max {FIRST_SLICE_MAIN[3]}); tracked "
          f"{n}/{N_FRAMES}, keyframes {int(slam.state.n_kf)} (all with BoW), "
          f"map points {int(slam.state.n_mp)}, ATE {ate:.6f} m; launches "
          f"fast_nms {launches['fast_nms']}, pose_lm {launches['pose_lm']} "
          f"({calls} pose_optimize calls, {stepped} frames stepped)",
          flush=True)
    return launches


def phase_reloc(SLAM, cfg, synthetic, counters):
    _, pose_lm_cuda, pose_opt = counters
    rcfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    max_frames_hint=6))
    seq = synthetic.generate(cfg.camera, n_frames=60, n_points=300,
                             trajectory="xyz", seed=0)
    slam = run_slam(SLAM, rcfg, seq, 45)
    check(slam.status == 2, f"status {slam.status} after 45 frames")
    kfs = int(slam.state.n_kf)
    check(kfs > 5, f"only {kfs} keyframes before the blind frames")
    # count the kernel launches made inside relocalisation attempts
    spent = []
    run_reloc = slam._run_reloc

    def counted(frame):
        before = pose_lm_cuda.launches
        out = run_reloc(frame)
        spent.append(pose_lm_cuda.launches - before)
        return out

    slam._run_reloc = counted
    blank = np.zeros_like(seq.images[0])
    for k in range(4):
        slam.track_mono(blank, seq.timestamps[45] + 0.001 * (k + 1))
    slam.flush()
    check(slam.status != 2, "still OK on blank frames")
    calls0, launches0 = pose_opt.cuda_calls, pose_lm_cuda.launches
    run_slam(SLAM, rcfg, seq, 55, start=38, slam=slam)
    check(slam.status == 2, "did not relocalise")
    check(int(slam.state.n_kf) >= kfs, "the map was reset")
    check(spent and all(s == 12 for s in spent),
          f"relocalisation attempts launched {spent} pose LMs, not 12 each "
          "(4 candidates x 3)")
    check(pose_opt.cuda_calls - calls0 == pose_lm_cuda.launches - launches0,
          "a pose LM bypassed the kernel")
    print(f"relocalisation: recovered after 4 blind frames, keyframes "
          f"{kfs} -> {int(slam.state.n_kf)}, {len(spent)} attempts, "
          f"pose_lm launches per attempt {spent}", flush=True)


def e2e_small_cfg(config):
    """tests/test_e2e.py's small monocular configuration."""
    cam = config.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                              width=320, height=240, fps=30.0, bf=0.0,
                              th_depth=35.0)
    return config.SLAMConfig(
        camera=cam, orb=config.ORBConfig(n_features=500, max_keypoints=512),
        cap=config.Capacity(max_keyframes=96, max_points=6144,
                            max_obs_per_kf=512, max_frames=512,
                            local_ba_points=2048))


def phase_loop(SLAM, cfg, synthetic, evaluate):
    seq = synthetic.generate(cfg.camera, n_frames=LOOP_FRAMES, n_points=300,
                             trajectory="loop", seed=1, loop_revolutions=1.3)
    t0 = time.perf_counter()
    open_loop = run_slam(SLAM, cfg, seq, LOOP_FRAMES,
                         enable_loop_closing=False)
    ate_open, n_open = ate_of(open_loop, seq, evaluate)
    closed = run_slam(SLAM, cfg, seq, LOOP_FRAMES)
    ate_closed, n_closed = ate_of(closed, seq, evaluate)
    print(f"loop closing: open ATE {ate_open:.6f} m ({n_open} tracked), "
          f"closed ATE {ate_closed:.6f} m ({n_closed} tracked), loop at "
          f"keyframe {closed.last_loop_kf} of {int(closed.state.n_kf)}, "
          f"{time.perf_counter() - t0:.1f} s for both", flush=True)
    check(closed.last_loop_kf > 0, "loop closure never fired")
    check(ate_closed <= 1.05 * ate_open,
          f"loop correction hurt: {ate_closed} vs open {ate_open}")


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    try:
        from orb_slam2_tpu_torch import config
        from orb_slam2_tpu_torch.frontend import fast_cuda, pyramid
        from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
        from orb_slam2_tpu_torch.io import evaluate, synthetic
        from orb_slam2_tpu_torch.pipeline.system import SLAM
        from orb_slam2_tpu_torch.solvers import pose_lm_cuda, pose_opt
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
    counters = (fast_cuda, pose_lm_cuda, pose_opt)
    try:
        # 2. build both kernels at once (one nvcc each)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            libs = list(ex.map(lambda m: m.build(verbose=True),
                               (fast_cuda, pose_lm_cuda)))
        print(f"build: {libs} in {time.perf_counter() - t0:.2f} s",
              flush=True)

        # 3. FAST kernel vs plain version, at the main path's shapes
        cfg = config.SLAMConfig()
        cam = cfg.camera
        levels = pyramid.level_shapes(cam.height, cam.width,
                                      cfg.orb.n_levels, cfg.orb.scale_factor)
        rows = check_fast(fast_cuda, levels + [(70, 128)])
        check(all(r["exact"] for r in rows),
              "fast_nms kernel disagrees with its plain version")
        frame_rows = rows[:len(levels)]
        if all(r["device_ms"] is not None for r in frame_rows):
            print(f"fast_nms, one frame's 8 levels: calls "
                  f"{sum(r['ms'] for r in frame_rows):.4f} ms, kernels on "
                  f"the device {sum(r['device_ms'] for r in frame_rows):.5f}"
                  f" ms, bound {sum(r['bound_ms'] for r in frame_rows):.5f}"
                  " ms", flush=True)
        seq = synthetic.generate(cam, n_frames=N_FRAMES, n_points=500,
                                 trajectory="xyz", seed=0)
        ext_gpu = build_atlas_extractor(cfg.orb, cam.height, cam.width,
                                        "cuda")
        ext_cpu = build_atlas_extractor(cfg.orb, cam.height, cam.width, "cpu")
        img0 = torch.as_tensor(seq.images[0])
        fg, fc = ext_gpu(img0.cuda()), ext_cpu(img0)
        same = ((fg.valid.cpu() == fc.valid) & (fg.octave.cpu() == fc.octave)
                & ((fg.uv.cpu() - fc.uv).abs().amax(-1) <= 1e-3))
        print(f"extractor card vs CPU: {float(same.float().mean()):.4f} of "
              f"{same.numel()} slots agree", flush=True)
        check(float(same.float().mean()) >= 0.99,
              "extractor on the card disagrees with the CPU run")

        # 4. pose-LM kernel vs plain version
        pose_rows = check_pose_lm(pose_lm_cuda, pose_opt, config.BAConfig)

        # 5. main path, vocabulary on
        launches = phase_main(SLAM, cfg, seq, evaluate, counters)

        # 6. relocalisation, 7. loop closing
        phase_reloc(SLAM, cfg, synthetic, counters)
        phase_loop(SLAM, e2e_small_cfg(config), synthetic, evaluate)

        # 8. determinism
        a = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
        b = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
        check(a.shape == b.shape and (a == b).all(),
              "two identical runs gave different trajectories")
        print(f"determinism: two {DET_FRAMES}-frame runs bit-identical "
              f"({a.shape[0]} poses)", flush=True)
    except PhaseError as e:
        return fail(str(e))

    main_row = pose_rows[0]          # the shape tracking gives it: B=1, N=1024
    kernels = [{
        "name": "fast_nms", "route": "cuda",
        "source": "orb_slam2_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orb_slam2_tpu/frontend/pallas_fast.py:42",
        "launches": launches["fast_nms"],
        "max_abs_err": max(r["err"] for r in rows),
        # one frame's worth of launches: the 8 pyramid levels
        "ms": sum(r["ms"] for r in frame_rows),
        "plain_ms": sum(r["plain_ms"] for r in frame_rows),
        "bound_ms": sum(r["bound_ms"] for r in frame_rows),
        "bound_by": frame_rows[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "pose_lm", "route": "cuda",
        "source": "orb_slam2_tpu_torch/csrc/pose_lm.cu",
        "replaces": "scripts/study_pallas_pose.py:148",
        "launches": launches["pose_lm"],
        "max_abs_err": max(r["err"] for r in pose_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        # no single PyTorch call computes a robust LM pose optimization
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
