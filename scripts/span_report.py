"""One benchmark run of a cell, read through the program's span log.

    python3 scripts/span_report.py --workload <cell> --seed <n>
        [--seconds 30] [--spans on|off] [--out PATH]

Runs the cell once as `python3 -m portbench --trace 0` does
(`portbench.run.run_cell`: set-up, the timed window, the check), with
the span log on (the default) or off (`spans.enable(False)`, to measure
what the log costs), and prints one JSON object: the run's end-to-end
metrics and `correct`; with the log on also the window's eight
`program_span` metrics (`portbench/metrics/`), the spans of the window's
frames (dp: steps) as host ms a frame, the window's device ms a frame by
interval name, and the window's unprofiled idle seconds put down to the
innermost span open when each idle stretch began
(`spans.Log.idle_by_span`; "no span" is the harness's own time between
calls), the quantiles of the window dispatches' (dp: steps') device ms,
and what the program's device counts (`control.Count`: tracking's path,
insertions, stages) added over the window.  Needs a CUDA card.  `--out`
appends the object to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, registry, run, window  # noqa: E402

METRICS = ("session.hud_wait_ms", "session.reaction_ms", "session.flush_ms",
           "session.step_device_ms", "session.step_device_ms_p95",
           "loop.verify_ms", "window_idle_share", "capture_s")


def device_counts() -> dict:
    """The program's device counts by name (host reads)."""
    from orb_slam2_tpu_torch.core import control
    from orb_slam2_tpu_torch.pipeline import mapping, system, tracking
    out = {"insert_calls": int(system.insert_calls)}
    out.update({"stage_calls." + k: int(c)
                for k, c in system.stage_calls.items()})
    for mod in (tracking, mapping):
        for k, c in vars(mod).items():
            if isinstance(c, control.Count):
                out[k] = int(c)
    return out


def window_spans(w) -> dict:
    """Host ms a frame of each span inside the window's frames (total and
    self), the boundaries' records, and device ms a frame by name."""
    n = len(w.frames)
    names = sorted({k for r in w.frames for k in r.sums})
    host = {k: [sum(r.ns(k) for r in w.frames) / 1e6 / n,
                sum(r.ns(k, True) for r in w.frames) / 1e6 / n]
            for k in names}
    bounds = {}
    for r in w.records:
        if r not in w.frames:
            b = bounds.setdefault(r.name, [0, 0.0])
            b[0] += 1
            b[1] += r.dur_s * 1e3
    dev = {}
    for iv in w.intervals:
        dev[iv[0]] = dev.get(iv[0], 0.0) + iv[5] / n
    return {"frames": n, "host_ms_a_frame": host, "boundaries": bounds,
            "device_ms_a_frame": dev}


def main(argv=None) -> int:
    run._fix_caches()
    t_start = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", choices=("on", "off"), default="on")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("span_report: no CUDA card", file=sys.stderr)
        return 3
    from orb_slam2_tpu_torch.core import spans
    spans.enable(args.spans == "on")
    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    got = {}
    build = harness.build

    def kept(*a, **kw):
        drv = build(*a, **kw)
        timed = drv.window

        def window_kept(seconds, events):
            got["counts0"] = device_counts()
            win = timed(seconds, events)
            got["counts"] = {k: v - got["counts0"][k]
                             for k, v in device_counts().items()}
            got["rec"] = {"mode": registry.traffic(cell["traffic"])["mode"],
                          "window_s": win.seconds,
                          "timings_ms": win.timings_ms,
                          "step_ms": win.step_ms}
            return win
        drv.window = window_kept
        return drv

    harness.build = kept
    try:
        res = run.run_cell(bench, cell, args.seed, args.seconds, False,
                           "cuda", t_start)
    finally:
        harness.build = build
    out = {"workload": cell["name"], "seed": args.seed, "spans": args.spans,
           "device": torch.cuda.get_device_name(0),
           "correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "window_s": got["rec"]["window_s"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
    rec = got["rec"]
    w = window.select(rec)
    if w is not None:
        out["window_metrics"] = {m: registry.reader(m)(rec) for m in METRICS}
        out["window"] = window_spans(w)
        lo = w.records[0].t0
        idle = w.log.idle_by_span(lo, lo + round(rec["window_s"] * 1e9))
        out["idle_s"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
        out["idle_share_by_span"] = {k: 100 * v / rec["window_s"]
                                     for k, v in out["idle_s"].items()}
        xs = window.device_ms(w, "step" if rec["mode"] == "dp"
                              else "dispatch")
        out["device_ms_quantiles"] = statistics.quantiles(xs, n=20) \
            if len(xs) >= 2 else xs
        out["device_counts"] = got["counts"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
