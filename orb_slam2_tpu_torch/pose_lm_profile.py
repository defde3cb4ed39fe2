"""Where a pass of the pose-LM kernel goes on the card.

    python3 -m orb_slam2_tpu_torch.pose_lm_profile [--problems 8] [--cluster C]

Builds csrc/pose_lm.cu twice (with the cluster size, the source's own by
default) and runs seeded N = 1024 mono pose problems (those of
`chip_smoke.py` phase 4's cluster sweep) through each:

* -DPOSE_LM_PROFILE: the SM cycles that one thread spends in each phase: a
  pass's linearization, reduction and exchange, and decision; an LM
  iteration's Cholesky solve and retraction (the marks slow the kernel);
* -DPOSE_LM_TIMER: a launch's own time, thread 0's global timer from its
  first instruction to its last, beside CUDA events around the launch
  with the card kept busy before them and torch.profiler's time.

Prints them with the card's name, power limit and top SM clock.  A pass is
one linearization: an LM iteration's, a round's first, or the final
classification.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.config import BAConfig
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.solvers import pose_lm_cuda

PHASES = ("linearize", "reduce", "decide", "solve", "retract")
N_COUNTERS = len(PHASES) + 2      # and the whole run: SM cycles, timer ns
SLEEP_CYCLES = 400_000            # ~0.2 ms of a busy card before a launch


def pose_problem(gen, B: int, N: int, stereo_frac: float, bf: float):
    """B seeded pose problems on the card: points 2-8 m ahead, a pose ~0.05
    off the truth, half-pixel noise, ~10% outliers, ~3% invalid rows."""
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


def _traced_ms(fn, reps: int = 5):
    """torch.profiler's mean device time of the pose_lm kernel over the
    launches of `reps` that its trace recorded, or None without a record."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "pose_lm_kernel" in e.key]
    seen = sum(int(e.count) for e in ev)
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in ev)
    return us / seen / 1e3 if seen else None


def _open(defines):
    lib = pose_lm_cuda.open_library(
        cuda_build.build(pose_lm_cuda.SOURCE, False, defines))
    lib.pose_lm_phase_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.pose_lm_phase_reset.argtypes = []
    for fn in (lib.pose_lm_phase_read, lib.pose_lm_phase_reset):
        fn.restype = ctypes.c_int
    return lib


def _launches(lib, probs, cfg, bf):
    """For each problem, one launch between two CUDA events with the card
    busy before them: (its counters, LM iterations, event ms), then
    torch.profiler's ms over a few more launches."""
    buf = (ctypes.c_longlong * N_COUNTERS)()
    rows = []
    for prob in probs:
        call = lambda: pose_lm_cuda.run(lib, *prob, bf, cfg)
        call()                                        # warm
        torch.cuda.synchronize()
        lib.pose_lm_phase_reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        n_iter = call()[4]
        b.record()
        torch.cuda.synchronize()
        lib.pose_lm_phase_read(buf)
        rows.append((list(buf), int(n_iter[0]), a.elapsed_time(b),
                     _traced_ms(call)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", type=int, default=8)
    ap.add_argument("--cluster", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    size = [] if args.cluster is None else [
        f"-DPOSE_LM_CLUSTER={args.cluster}"]
    profiled = _open(["-DPOSE_LM_PROFILE"] + size)
    timed = _open(["-DPOSE_LM_TIMER"] + size)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg, bf = BAConfig(), 40.0
    probs = [pose_problem(gen, 1, 1024, 0.0, bf)
             for _ in range(args.problems)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")

    rows = _launches(profiled, probs, cfg, bf)
    sums = [sum(r[0][k] for r in rows) for k in range(len(PHASES))]
    iters = sum(r[1] for r in rows)
    passes = iters + len(rows) * (cfg.pose_opt_rounds + 1)
    per = [s / passes for s in sums[:3]] + [s / iters for s in sums[3:]]
    print(f"profiling build, cluster of {profiled.cluster} blocks, "
          f"{len(rows)} problems, {iters} LM iterations, {passes} passes; "
          "SM cycles a pass: " +
          ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES[:3], per)) +
          "; an LM iteration: " +
          ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES[3:], per[3:])) +
          f"; all phases: {sum(sums) / passes:.0f} a pass")

    rows = _launches(timed, probs, cfg, bf)
    n = len(rows)
    traced = [r[3] for r in rows if r[3] is not None]
    print(f"timer build, a launch, mean of {n}: thread 0's global timer "
          f"{sum(r[0][6] for r in rows) / n / 1e6:.5f} ms "
          f"({sum(r[0][5] for r in rows) / n:.0f} SM cycles); CUDA events "
          f"around it, the card busy before them, "
          f"{sum(r[2] for r in rows) / n:.5f} ms; torch.profiler "
          + (f"{sum(traced) / len(traced):.5f} ms ({len(traced)} of {n} "
             "traced)" if traced else "no record"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
