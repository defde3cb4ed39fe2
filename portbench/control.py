"""The correctness check's controls, read at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--seconds S] [--tf32] [--no-loop] [--out PATH]

For each seed it runs the cell once as the benchmark does and prints the
numbers the check compares, then the readings of the controls, each
judged by the cell's limits (`check.judge`):

- `bf16`: the plain reference put in the program's place and computed
  in bfloat16, the precision below the float32 the configuration states:
  its steered BRIEF at the program's keypoints (`desc_bit_share`), its
  BoW rows of the program's keyframe descriptors (`bow_gap`), its loop
  detection over those rows (`detect_miss`, and its score gap), and
  the ground truth's camera centres, expressed in the map's frame and
  rounded to bfloat16, as the poses (`ate_m`); it is judged with the
  program's readings of the numbers it does not replace;
- with `--tf32`, `tf32`: the program itself with its float32 products in
  TF32 (`torch.backends.cuda.matmul.allow_tf32`), its own path to a lower
  precision, read and judged as a run is;
- with `--no-loop`, `no_loop`: the program with its loop closing off
  (`SLAM(enable_loop_closing=False)`), read and judged as a run is: the
  upper side of `loop_open_passes` and `loop_junction_m`.

Each also reads `plane_p50_m`, the median of the map points' distance to
the room's nearest plane (the map placed by the ground-truth pose of its
first frame), which no limit holds (`PERF.md`).  The benchmark's own runs
never run this.  Prints one JSON object a seed and a summary as the last
line; `--out` also writes the summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import check, reference, registry, render, run


def gt_ate_bf16(out: dict, gt_of) -> float:
    """The worst pass's ATE of the ground truth's camera centres, in the
    frame of the map's first frame and rounded to bfloat16, against the
    ground truth."""
    worst = None
    for p in out["passes"]:
        s = p.get("seq", 0)
        gt = gt_of(s)
        first = out["map_first_idx"][s]
        if first is None:
            continue
        R0 = render._rotations(gt[None, first, :4])[0]
        t0 = gt[first, 4:]
        ok, _ = check.camera_centres(p["traj"], p["kf_pose"])
        n = min(len(ok), len(p["idx"]))
        pos = gt[p["idx"][:n]][:, 4:]
        local = (pos - t0) @ R0                 # R0^T (pos - t0)
        low = torch.as_tensor(local).to(torch.bfloat16).double().numpy()
        sel = ok[:n]
        if sel.sum() < check.MIN_FRAMES:
            continue
        e = reference.ate(low[sel], pos[sel])[0]
        worst = e if worst is None else max(worst, e)
    return worst


def plane_p50(out: dict, room_of, gt_of) -> float:
    """The median of the map points' distance to the room (the worst
    sequence's), the map placed by its first frame's true pose."""
    worst = None
    for s, (pts, i0) in enumerate(zip(out["points"], out["map_first_idx"])):
        if not len(pts) or i0 is None:
            continue
        twc = gt_of(s)[i0]
        R = render._rotations(twc[None, :4])[0]
        pw = pts.astype(np.float64) @ R.T + twc[4:]
        room = room_of(s)
        v = float(np.median(reference.plane_distances(
            pw, room.planes, room.extents)))
        worst = v if worst is None else max(worst, v)
    return worst


def bf16_numbers(keep: dict, device) -> dict:
    out = keep["out"]
    res = {"desc_bit_share": check.descriptor_share(
               out, keep["cam"], keep["orb"], keep["image_of"], device,
               dtype=torch.bfloat16, against=torch.float32),
           "ate_m": gt_ate_bf16(out, keep["gt_of"])}
    table = out.get("table")
    if keep["voc"] is not None and table is not None:
        rows = check.reference_rows(table, keep["voc"], keep["width"])
        low = check.reference_rows(table, keep["voc"], keep["width"],
                                   torch.bfloat16)
        res["bow_gap"] = check.bow_gap(dict(table, rows=low), rows)
        got = {q: r["ids"] for q, r in check.detections(
            table, low, torch.bfloat16).items()}
        det = check.detection_numbers(got, check.detections(table, rows))
        res["detect_miss"] = det["detect_miss"]
        res["detect_score_gap"] = det["counts"]["score_gap"]
    return res


def judged(nums: dict, limits: dict) -> dict:
    ok, rows = check.judge(nums, limits)
    return {"correct": ok, "failing": [n for n, v, lim in rows
                                       if not (v is not None and v <= lim)]}


def main(argv=None) -> int:
    run._fix_caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    limits = run.limits_for(registry.config(cell["config"]), cell)
    rows = []
    for seed in args.seeds:
        keep = {}
        r = run.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                         time.time(), keep=keep)
        low = bf16_numbers(keep, "cuda")
        row = {"seed": seed, "program": dict(
                   keep["nums"], plane_p50_m=plane_p50(
                       keep["out"], keep["room_of"], keep["gt_of"])),
               "program_correct": r["correct"],
               "failed": r["failed"], "attempted": r["attempted"],
               "fill": r["checks"]["fill"],
               "detect_queries": r["checks"].get("detect_queries"),
               "loop": r["checks"].get("loop"),
               "bf16": low,
               "bf16_judged": judged(dict(keep["nums"], **low), limits)}
        del keep
        if args.tf32:
            keep = {}
            r = run.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                             time.time(), tf32=True, keep=keep)
            row["tf32"] = dict(keep["nums"], plane_p50_m=plane_p50(
                keep["out"], keep["room_of"], keep["gt_of"]))
            row["tf32_judged"] = judged(keep["nums"], limits)
            row["tf32_correct"] = r["correct"]
            row["tf32_failed"] = r["failed"]
            del keep
        if args.no_loop:
            keep = {}
            r = run.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                             time.time(), keep=keep, loop=False)
            row["no_loop"] = dict(keep["nums"], plane_p50_m=plane_p50(
                keep["out"], keep["room_of"], keep["gt_of"]))
            row["no_loop_judged"] = judged(keep["nums"], limits)
            row["no_loop_correct"] = r["correct"]
            row["no_loop_checks"] = r["checks"]
            del keep
        print(json.dumps(row), flush=True)
        rows.append(row)
    keys = sorted({k for r in rows for k in r["program"]})
    summary = {"workload": cell["name"], "seeds": args.seeds,
               "limits": limits}
    for side in ("program", "bf16", "tf32", "no_loop"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = {k: [g.get(k) for g in got] for k in keys}
    for side in ("bf16_judged", "tf32_judged", "no_loop_judged"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = got
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
