"""The comparison that decides `correct`: the numbers the plain reference
reads from what the timed path produced, each beside its limit.

Numbers (each over the whole run; the limits are per cell, in
`limits/<cell>.json`, set from the readings that `PERF.md` gives):

- `ate_m`: the worst pass's (dp: sequence's) ATE RMSE in metres of the
  frames the program tracked, against the renderer's ground truth after
  a rigid alignment (tracking; each frame's pose is its reference
  keyframe's final pose, so the mapping stages count too);
- `ate_per_m`: the worst pass's ATE over the distance its camera
  travelled (passes of 5 m or more);
- `untracked_share`: the worst pass's (dp: sequence's) share of frames
  with no pose (the configurations state that every fed frame is
  tracked; such frames also count as failed);
- `desc_bit_share`: the share of descriptor bits that differ from the
  reference's steered BRIEF at the same keypoints, over the window's last
  frames (the session's ring) and a sample of the final map's keyframes
  drawn from the seed (extraction);
- `bow_gap`: the widest gap between a live keyframe's BoW row (every
  keyframe of the final map) and the reference's transform of its
  descriptors (place recognition, session cells with a vocabulary);
- `detect_miss`: the program's loop detection for each sampled keyframe
  over the final map against the reference's (`reference.loop_candidates`,
  on the reference's own rows): the queries whose candidates differ, by
  an id that one side keeps and the other not, or by an accumulated
  score more than `DETECT_SCORE_ATOL` from the reference's.  A query
  whose reference decision lies within `DETECT_TIE` of a threshold or a
  tie is left out (the program's float32 may decide it either way) and
  counted apart.

Two numbers of a drive that comes back to its start (`render.lap_frames`:
frame i + lap is at frame i's pose, so a pass that reaches frame `lap`
revisits its start); computed only when a pass revisits, and judged only
where a cell's limits name them:

- `loop_open_passes`: the revisiting passes that ended with no loop
  correction, read from the program's span log (a `correct` span whose
  frame lies in the pass; `harness.Session.corrections`) (loop closing);
- `loop_junction_m`: over the revisiting passes, the worst error of a
  relative pose, | t(Ti^-1 Tj) - t(Gi^-1 Gj) |, the poses T after the
  final keyframe poses as `camera_centres` builds them, G the ground
  truth, of two kinds: every tracked frame past the lap against the
  same place one lap earlier (a loop left open keeps its drift there),
  and every step between tracked frames from half a lap on (tracking that
  snaps back onto the old map, or a correction that leaves a seam, jumps
  there), so that no single frame at the return can meet it (loop
  correction, pose graph and global BA; no reading when no tracked frame
  past the lap has its place tracked).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from portbench import reference, render

MIN_FRAMES = 10     # a pass's ATE needs this many tracked frames
MIN_PATH_M = 5.0    # and its ATE per metre a path this long
DETECT_TIE = 1e-5   # a detection decided closer than this is left out
# a candidate's score tolerance: the port's own check of detection at the
# reference vocabulary's width (chip_smoke.py DETECT_SCORE_ATOL)
DETECT_SCORE_ATOL = 1e-5


# --- SE3 as the program stores it: quaternion wxyz, then t (Tcw) ---------

def _qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def _qrot(q, v):
    qv, w = q[..., 1:], q[..., :1]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def camera_poses(traj: np.ndarray, kf_pose: np.ndarray):
    """(tracked mask [n], Tcw rotations as quaternions [n, 4], camera
    centres [n, 3]) of trajectory rows [n, 17] (Tcw, Tcr, reference
    keyframe, ok, timestamp): each frame's Tcw is its Tcr after its
    reference keyframe's final Tcw."""
    traj = traj.astype(np.float64)
    ref = traj[:, 14].astype(np.int64)
    ok = (traj[:, 15] > 0.5) & (ref >= 0)
    kp = kf_pose.astype(np.float64)[np.clip(ref, 0, len(kf_pose) - 1)]
    q = _qmul(traj[:, 7:11], kp[:, :4])
    t = _qrot(traj[:, 7:11], kp[:, 4:]) + traj[:, 11:14]
    qc = q * np.array([1.0, -1, -1, -1])
    return ok, q, -_qrot(qc, t)


def camera_centres(traj: np.ndarray, kf_pose: np.ndarray):
    """(tracked mask [n], camera centres [n, 3]): `camera_poses`."""
    ok, _, c = camera_poses(traj, kf_pose)
    return ok, c


def trajectory_errors(passes: List[dict], gt_of: Callable) -> dict:
    """ATE of each pass with >= MIN_FRAMES tracked frames; tracked and
    attempted frames over all passes (from each pass's `window_row`: a
    pass's first rows may have run in set-up)."""
    ates, per_m, untracked, tracked, rows = [], [], [], 0, 0
    for p in passes:
        ok, c = camera_centres(p["traj"], p["kf_pose"])
        n = min(len(ok), len(p["idx"]))
        ok, c = ok[:n], c[:n]
        w0 = min(p.get("window_row", 0), n)
        tracked += int(ok[w0:].sum())
        rows += n - w0
        if n:
            untracked.append(1.0 - ok.sum() / n)
        if ok.sum() >= MIN_FRAMES:
            gt = gt_of(p)[p["idx"][:n]][:, 4:]
            path = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
            e = reference.ate(c[ok], gt[ok])[0]
            ates.append(e)
            if path >= MIN_PATH_M:
                per_m.append(e / path)
    return {"ates": ates, "per_m": per_m, "untracked": untracked,
            "tracked": tracked,
            "rows": rows}


def loop_numbers(passes: List[dict], gt_of: Callable, lap: int,
                 corrections: Optional[List[int]]) -> Optional[dict]:
    """`loop_open_passes` and `loop_junction_m` over the passes that
    revisit their start (`lap`: a lap's frames, `render.lap_frames`), and
    each such pass's readings (`overrun_m`, and `step_m` at `step_row`);
    None when no pass revisits."""
    rows, open_passes, errs = [], 0, []
    for p in passes:
        n = min(len(p["traj"]), len(p["idx"]))
        idx = np.asarray(p["idx"][:n], dtype=np.int64)
        if not (idx >= lap).any():
            continue
        fids = [f for f in corrections or ()
                if f is not None and p["fid0"] <= f < p["fid0"] + n]
        open_passes += not fids
        ok, q, c = camera_poses(p["traj"][:n], p["kf_pose"])
        gt = gt_of(p)[idx]
        R = render._rotations(gt[:, :4])

        def err(i, j):
            est = _qrot(q[i], c[j] - c[i])
            return float(np.linalg.norm(est - (gt[j, 4:] - gt[i, 4:]) @ R[i]))

        tracked = np.nonzero(ok)[0]
        row_of = {}
        for r in tracked:
            row_of.setdefault(int(idx[r]), int(r))
        over = [err(row_of[int(idx[r]) - lap], r) for r in tracked
                if int(idx[r]) - lap in row_of]
        steps = [(err(i, j), int(j)) for i, j in zip(tracked[:-1], tracked[1:])
                 if 2 * idx[j] >= lap]
        overrun = max(over) if over else None
        step, step_row = max(steps) if steps else (None, None)
        err_p = None if overrun is None else max(overrun, step or 0.0)
        errs.append(err_p)
        rows.append({"fid0": int(p["fid0"]),
                     "window_row": int(p.get("window_row", 0)),
                     "corrections": [int(f) for f in fids],
                     "overrun_m": overrun, "step_m": step,
                     "step_row": step_row, "junction_m": err_p})
    if not rows:
        return None
    return {"loop_open_passes": None if corrections is None
            else open_passes,
            "loop_junction_m": None if None in errs else max(errs),
            "passes": rows}


def raw_positions(cam: render.Camera, uv: np.ndarray) -> np.ndarray:
    """Raw (distorted) pixel positions of undistorted keypoints uv [n, 2]."""
    if not cam.has_lens:
        return uv
    x = (uv[:, 0].astype(np.float64) - cam.cx) / cam.fx
    y = (uv[:, 1].astype(np.float64) - cam.cy) / cam.fy
    u, v = render.distort_pixels(cam, x, y)
    return np.stack([u, v], 1)


def descriptor_sets(out: dict, cam: render.Camera):
    """(image key, frame index, raw uv, octave, packed descriptors) of every
    checked image: the ring's frames, then the sampled keyframes."""
    sets = []
    ring = out.get("ring")
    if ring is not None:
        for r, i in enumerate(ring["idx"]):
            v = ring["valid"][r]
            sets.append((0, int(i), ring["uv_raw"][r][v].astype(np.float64),
                         ring["octave"][r][v], ring["desc"][r][v]))
    kf_sets = out["keyframes"]
    if isinstance(kf_sets, dict):
        kf_sets = [kf_sets]
    for kfs in kf_sets:
        s = kfs.get("seq", 0)
        for r, i in enumerate(kfs["idx"]):
            v = kfs["kf_kp_valid"][r]
            sets.append((s, int(i), raw_positions(cam, kfs["kf_uv"][r][v]),
                         kfs["kf_octave"][r][v], kfs["kf_desc"][r][v]))
    return sets


def descriptor_share(out: dict, cam: render.Camera, orb: dict,
                     image_of: Callable, device, dtype=torch.float32,
                     against: Optional[torch.dtype] = None) -> float:
    """Share of descriptor bits that differ from the reference's.  With
    `against`, the reference at `dtype` (the control) is held to the
    reference at `against` at the program's keypoints instead."""
    diff = total = 0
    for s, i, uv, oc, desc in descriptor_sets(out, cam):
        img = image_of(s, i)
        if against is not None:
            blurred, shapes = reference.blurred_levels(
                torch.as_tensor(np.asarray(img, np.float32), device=device),
                orb["n_levels"], orb["scale_factor"], orb["blur_ksize"],
                orb["blur_sigma"], dtype)
            cand = reference.level_coords(uv, oc, orb["scale_factor"])
            lv = torch.as_tensor(oc.astype(np.int64), device=device)
            desc, _ = reference.steered_brief(
                blurred, shapes, lv,
                torch.as_tensor(cand[:, 0, 0], device=device),
                torch.as_tensor(cand[:, 0, 1], device=device))
            desc = desc.cpu().numpy()
            d, n = reference.descriptor_bits(img, uv, oc, desc, orb, device,
                                             against)
        else:
            d, n = reference.descriptor_bits(img, uv, oc, desc, orb, device,
                                             dtype)
        diff += d
        total += n
    return diff / total if total else float("nan")


def reference_rows(table: dict, voc: dict, width: int,
                   dtype=torch.float64) -> list:
    """The reference's BoW row of every live keyframe of the table."""
    live = np.nonzero(table["valid"])[0]
    rows = [None] * len(table["valid"])
    for k, r in zip(live, reference.bow_rows(
            voc, [table["desc"][k] for k in live], width, dtype)):
        rows[k] = r
    return rows


def bow_gap(table: dict, ref_rows: list) -> float:
    """Widest gap between the live keyframes' BoW rows and the
    reference's rows of their descriptors."""
    gaps = [reference.row_gap(a, b) for a, b in zip(table["rows"], ref_rows)
            if a is not None]
    return max(gaps) if gaps else 0.0


def detections(table: dict, ref_rows: list, dtype=None) -> dict:
    """The reference's loop candidates for each of the table's queries."""
    return {q: reference.loop_candidates(ref_rows, table["valid"],
                                         table["covis"], q, dtype=dtype)
            for q in table["detect"]}


def detection_numbers(got: dict, ref: dict) -> dict:
    """Queries whose candidates differ from the reference's (ids, or a
    score beyond DETECT_SCORE_ATOL), and the widest score gap, over the
    queries decided clear of every tie; the counts of queries compared,
    left out and with candidates."""
    miss, gap, compared, tied, found = 0, 0.0, 0, 0, 0
    for q, r in ref.items():
        if r["margin"] < DETECT_TIE:
            tied += 1
            continue
        compared += 1
        found += bool(r["ids"])
        g = got[q]
        both = set(g) & set(r["ids"])
        worst = max((abs(g[i] - r["ids"][i]) for i in both), default=0.0)
        gap = max(gap, worst)
        miss += set(g) != set(r["ids"]) or worst > DETECT_SCORE_ATOL
    return {"detect_miss": miss,
            "counts": {"compared": compared, "tied": tied,
                       "with_candidates": found, "score_gap": gap}}


def numbers(out: dict, cam: render.Camera, orb: dict, voc: Optional[dict],
            width: int, image_of: Callable, gt_of_seq: Callable,
            device, lap: Optional[int] = None) -> tuple:
    """Every number the check compares, the trajectory's counts, the
    detection's counts and (`lap`: a drive that comes back to its start
    after `lap` frames) the revisiting passes' loop readings."""
    gt_of = lambda p: gt_of_seq(p.get("seq", 0))
    traj = trajectory_errors(out["passes"], gt_of)
    res = {"ate_m": max(traj["ates"]) if traj["ates"] else None,
           "ate_per_m": max(traj["per_m"]) if traj["per_m"] else None,
           "untracked_share": max(traj["untracked"])
           if traj["untracked"] else None,
           "desc_bit_share": descriptor_share(out, cam, orb, image_of,
                                              device)}
    counts = None
    table = out.get("table")
    if voc is not None and table is not None:
        ref_rows = reference_rows(table, voc, width)
        res["bow_gap"] = bow_gap(table, ref_rows)
        det = detection_numbers(table["detect"],
                                detections(table, ref_rows))
        counts = det.pop("counts")
        res.update(det)
    loop = None
    if lap is not None:
        loop = loop_numbers(out["passes"], gt_of, lap,
                            out.get("corrections"))
        if loop is not None:
            res["loop_open_passes"] = loop["loop_open_passes"]
            res["loop_junction_m"] = loop["loop_junction_m"]
    return res, traj, counts, loop


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number present and
    at or under its limit; a number with no reading fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = nums.get(name)
        good = v is not None and v == v and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
