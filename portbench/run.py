"""Run one cell of the port's benchmark once.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds and sets up the program (`orb_slam2_tpu_torch`) for the cell named
in `BENCHMARK.json`, renders its inputs on the card from the seed, warms
up, measures for `--seconds` seconds, checks what the timed path produced
against the plain reference (`reference.py`, `check.py`), and prints one
JSON object as the last line of standard output.  With `--trace 0` its
metrics are the cell's end-to-end metrics; with `--trace 1` the window
records CUDA events around each call, and after it come the eager parts'
CUDA-event timings and, last of all, a short torch.profiler window; its
metrics are the cell's per-layer metrics (each read by
`metrics/<name>.py`).

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program, or when `jax`, `jaxlib`,
`flax` or the JAX package `orb_slam2_tpu` is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_tpu")


def _fix_caches():
    """Every kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def process_start() -> float:
    """This process's start time (epoch s), from /proc."""
    with open("/proc/self/stat") as f:
        ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(float(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `orb_slam2_tpu_torch` is not `orb_slam2_tpu`)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def p95(xs):
    return statistics.quantiles(xs, n=20)[18] if len(xs) >= 2 else None


def limits_for(conf: dict, cell: dict) -> dict:
    """The configuration's guarantees, then the limits measured for the
    cell."""
    from portbench import registry
    limits = dict(conf["guarantees"]["limits"])
    limits.update(registry.limits(cell["name"])["limits"])
    return limits


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: str, t_start: float,
             tf32: bool = False, keep: dict = None,
             loop: bool = True) -> dict:
    """One run of `cell`; returns the result object (correct, attempted,
    failed, metrics, device, [breakdown], checks).  `tf32` switches the
    program's float32 products to TF32 (the control's lower precision);
    `loop` False turns the session's loop closing off (the control of the
    loop numbers); a dict `keep` receives the outputs and inputs the check
    read."""
    import torch

    from portbench import check, harness, registry, render, trace, vocab

    conf = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = limits_for(conf, cell)
    # float32 as the configuration states (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = harness.build(conf, traffic, seed, device, loop)
    drv.setup()
    setup_s = time.time() - t_start
    win = drv.window(seconds, events=traced and cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rng = render.rng_for(seed, 7)
    rec = {"mode": traffic["mode"], "S": traffic.get("sequences", 1),
           "window_s": win.seconds, "timings_ms": win.timings_ms,
           "step_ms": win.step_ms}
    # the outputs first: the eager parts' timings below write the session's
    # keyframe table in place
    out = drv.outputs(rng, traffic["check_keyframes"])
    if traced and cuda and traffic["mode"] == "session":
        rec["stage_ms"] = drv.stage_times(traffic["stage_reps"])
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced and cuda:
        prof, wall, frames = drv.profiled(traffic["profile_frames"])
        red = trace.reduce_profile(prof)
        del prof
        rec["profile"] = {"kernels": red["kernels"], "frames": frames,
                          "wall_s": wall, "busy_s": red["busy_s"],
                          "trace_s": red["trace_s"]}
        cam = harness.camera(conf)
        orb = conf["orb"]
        rec["fast_bound_s"] = trace.fast_bound_s(
            cam.height, cam.width, orb["n_levels"], orb["scale_factor"],
            drv.fast_images())[0]
        if traffic["mode"] == "dp":
            rec["dp_phase_ms"] = drv.phases(traffic["phase_steps"])
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["trace_s"]
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}

    # the check: the program's state freed first, the reference after
    cam = harness.camera(conf)
    if traffic["mode"] == "dp":
        seqs = drv.seqs
        images = drv.images
        image_of = lambda s, i: images[s, i].cpu().numpy()
        gt_of = lambda s: seqs[s].twc
        room_of = lambda s: seqs[s].room
        window_rows = drv.window_steps
    else:
        host, seq = drv.host, drv.seq
        image_of = lambda s, i: host["images"][i]
        gt_of = lambda s: seq.twc
        room_of = lambda s: seq.room
        window_rows = None
    drv.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    voc, width = None, 0
    if conf["vocabulary"]["tree"] != "none":
        voc = vocab.load(vocab.path_for(conf["vocabulary"]))
        width = conf["vocabulary"]["branching"] ** conf["vocabulary"]["depth"]
    nums, traj, detect_counts, loop_counts = check.numbers(
        out, cam, conf["orb"], voc, width, image_of, gt_of, device,
        render.lap_frames(traffic["trajectory"], traffic.get("motion")))
    if window_rows is None:
        tracked = traj["tracked"]
    else:
        k0, k1 = window_rows
        tracked = 0
        for p in out["passes"]:
            ok, _ = check.camera_centres(p["traj"], p["kf_pose"])
            tracked += int(ok[k0:k1].sum())
    if keep is not None:
        keep.update(out=out, cam=cam, orb=conf["orb"], voc=voc, width=width,
                    image_of=image_of, gt_of=gt_of, room_of=room_of,
                    nums=nums)
    correct, rows = check.judge(nums, limits)
    cap = conf["cap"]
    full = (out["fill"]["keyframes"] >= cap["max_keyframes"] or
            out["fill"]["points"] >= cap["max_points"])
    if full:
        correct = False
    checks = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    if detect_counts is not None:
        checks["detect_queries"] = detect_counts
    if loop_counts is not None:
        checks["loop"] = loop_counts
    checks["fill"] = {"keyframes": out["fill"]["keyframes"],
                      "points": out["fill"]["points"],
                      "limit_keyframes": cap["max_keyframes"],
                      "limit_points": cap["max_points"]}
    failed = win.attempted - tracked
    if traced:
        metrics = {}
        for m in registry.per_layer(cell, bench):
            v = registry.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"frames_per_s": tracked / win.seconds,
               "frame_ms_p95": p95(win.timings_ms),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in registry.end_to_end(cell, bench)
                   if e2e.get(m["name"]) is not None}
    print(f"window: {win.attempted} frames in {win.seconds:.3f} s, of which "
          f"the closing flush and synchronisation {win.flush_s:.3f} s; "
          f"set-up {setup_s:.3f} s", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    _fix_caches()
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import registry
    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import orb_slam2_tpu_torch  # the program under test
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 4
    where = os.path.dirname(os.path.abspath(orb_slam2_tpu_torch.__file__))
    if os.path.dirname(where) != registry.ROOT:
        print(f"portbench: the program was loaded from {where}, not from "
              f"this checkout ({registry.ROOT})", file=sys.stderr)
        return 4
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    emit(result)
    return 0


def emit(result: dict, out=None, err=None):
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()),
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
