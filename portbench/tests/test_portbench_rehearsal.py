"""A tiny run of the harness on the CPU (its look for a card skipped):
the last line's shape, and `correct` false under each fault the cells can
have: a step that returns its state unchanged, half of the dp batch left
out, and an answer altered where it is produced.  The exchange between
chips has no cell here (every cell takes one card).  A tiny drive round a
block reads the loop numbers with the program's loop closing on and off,
and faults of a loop fail them: a revisiting pass whose correction is
suppressed, and (on a pass that is the ground truth) a junction 0.5 m
off and tracking that snaps back onto the start in one frame."""

import io
import json
import os
import time

import numpy as np
import pytest

from portbench import check, registry, render, run
from portbench.tests import conftest

BIG_SEED = 2 ** 31 + 4242


def rehearse(cell_name, bench, seconds=8.0, traced=False):
    cell = registry.cell(cell_name, bench)
    return run.run_cell(bench, cell, BIG_SEED, seconds, traced, "cpu",
                        time.time())


def test_last_line_shape(small_cells):
    res = rehearse("tum_rgbd.desk", small_cells)
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    last = err.getvalue().strip().splitlines()
    assert last[-1].startswith("check fill:")
    assert any(x.startswith("check ate_m: value") for x in last)


def test_traced_line_reports_per_layer_metrics(small_cells):
    """On the CPU only the host-clock per-layer metrics are there."""
    res = rehearse("tum_rgbd.desk", small_cells, traced=True)
    assert set(res["metrics"]) == {"frame_ms_p50", "session.frame_ms_p95"}


def _unchanged_session(monkeypatch):
    from orb_slam2_tpu_torch.pipeline import system
    monkeypatch.setattr(system.SLAM, "_run_program",
                        lambda self, loc_only: None)


def _unchanged_dp(monkeypatch):
    from orb_slam2_tpu_torch.distributed import dp

    def step(self, img, depth, fid, t):
        self.steps += 1
    monkeypatch.setattr(dp.DPProgram, "step", step)


def _half_batch(monkeypatch):
    from orb_slam2_tpu_torch.distributed import dp
    real = dp.DPProgram.step

    def step(self, img, depth, fid, t):
        h = img.shape[0] // 2
        img, depth = img.clone(), depth.clone()
        img[h:], depth[h:] = img[:1], depth[:1]
        return real(self, img, depth, fid, t)
    monkeypatch.setattr(dp.DPProgram, "step", step)


def _altered_descriptors(monkeypatch):
    from orb_slam2_tpu_torch.pipeline import system
    real = system.build_frame_fn

    def build(cfg, device=None):
        fn = real(cfg, device)

        def frame(*a):
            f = fn(*a)
            return f._replace(desc=f.desc ^ 0x55)
        return frame
    monkeypatch.setattr(system, "build_frame_fn", build)


@pytest.mark.parametrize("cell,fault", [
    ("tum_rgbd.desk", _unchanged_session),
    ("tum_rgbd.desk", _altered_descriptors),
    ("tum_rgbd.fleet8", _unchanged_dp),
    ("tum_rgbd.fleet8", _half_batch),
], ids=["session-unchanged", "session-altered-descriptors",
        "dp-unchanged", "dp-half-batch"])
def test_fault_makes_correct_false(small_cells, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = rehearse(cell, small_cells)
    assert res["correct"] is False, res["checks"]


# ---------------------------------------------------------------------------
# a drive that comes back to its start: kitti_stereo's lens cut to 320x240
# with fewer features and a smaller map, round a 1 m block on a ring road
# 4 m wide whose corners make a circle; the lap plays in set-up (~2-4 min
# a run on the CPU)
# ---------------------------------------------------------------------------

TINY_LOOP_MOTION = {"speed": 0.1, "block": 1.0, "ring": 4.0, "corner": 2.5,
                    "overrun": 20}
LOOP_LIMITS = {"loop_open_passes": 0, "loop_junction_m": 0.3}


def tiny_loop_config(name):
    c = conftest.small_config("kitti_stereo")
    cam = registry._json(os.path.join(registry.HERE, "configs",
                                      "kitti_stereo.json"))["camera"]
    s = 320 / cam["width"]
    c["camera"] = dict(cam, width=320, height=240, fx=cam["fx"] * s,
                       fy=cam["fy"] * s, cx=cam["cx"] * s,
                       cy=cam["cy"] * 240 / cam["height"], bf=cam["bf"] * s)
    c["orb"] = dict(c["orb"], n_features=500, max_keypoints=512)
    c["cap"] = dict(max_keyframes=96, max_points=6144, max_obs_per_kf=512,
                    max_frames=512, local_ba_points=2048)
    c["tracking"] = dict(c.get("tracking", {}), stereo_init_min_kps=300)
    return c


def tiny_loop_traffic(name):
    n = render.lap_frames("loop", TINY_LOOP_MOTION)
    return {"mode": "session", "trajectory": "loop", "play": "passes",
            "frames": n + TINY_LOOP_MOTION["overrun"], "warm_frames": 4,
            "warm_after": n, "stage_reps": 1, "check_keyframes": 4,
            "profile_frames": 4, "texture_seed": 1,
            "motion": TINY_LOOP_MOTION}


def loop_run(mp, keep=None, loop=True):
    """The tiny loop as the drive's cell, judged by LOOP_LIMITS beside the
    drive's own; `loop` False turns the program's loop closing off."""
    mp.setattr(registry, "config", tiny_loop_config)
    mp.setattr(registry, "traffic", tiny_loop_traffic)
    real = registry.limits
    mp.setattr(registry, "limits", lambda cell: {
        "limits": dict(real(cell)["limits"], **LOOP_LIMITS)})
    bench = registry.benchmark()
    return run.run_cell(bench, registry.cell("kitti_stereo.drive", bench),
                        BIG_SEED, 2.0, False, "cpu", time.time(), keep=keep,
                        loop=loop)


@pytest.mark.parametrize("loop", [True, False], ids=["closing", "no-loop"])
def test_loop_run_reads_the_loop_numbers(monkeypatch, loop):
    """Both numbers are read over the one revisiting pass, which began in
    set-up and is checked from its first frame while the window's frames
    alone are attempted; the program corrects the loop only with its loop
    closing on.  (Whether the junction meets its limit is the program's
    reading, not the harness's: on the CPU the corrected pass reads more
    than the loop-less one.)"""
    res = loop_run(monkeypatch, loop=loop)
    checks = res["checks"]
    for name, lim in LOOP_LIMITS.items():
        assert checks[name]["limit"] == lim
        assert checks[name]["value"] is not None
    n = render.lap_frames("loop", TINY_LOOP_MOTION)
    (p,) = checks["loop"]["passes"]
    assert p["window_row"] == n and res["attempted"] < n
    assert p["overrun_m"] is not None and p["step_m"] is not None
    assert bool(p["corrections"]) is loop
    assert checks["loop_open_passes"]["value"] == (0 if loop else 1)
    if not loop:
        assert res["correct"] is False


def test_suppressed_correction_makes_correct_false(monkeypatch):
    from orb_slam2_tpu_torch.pipeline import system
    monkeypatch.setattr(system.SLAM, "_correct_loop",
                        lambda self, kf_id, consistent, cause=None: None)
    res = loop_run(monkeypatch)
    assert res["checks"]["loop_open_passes"]["value"] == 1
    assert res["correct"] is False


def truth_pass(fault):
    """A pass of the tiny loop whose poses are the ground truth (every
    frame's Tcr its Tcw, about one keyframe at the origin), corrected at
    its lap's end, with `fault` applied to the camera centres: "offset",
    every frame from half the pass on 0.5 m off; "snap", a drift that grows
    to 0.8 m past the frames the overrun will revisit and is gone one frame
    before the lap's end, as when tracking snaps back onto the old map (the
    overrun then agrees with the lap's start)."""
    n_lap = render.lap_frames("loop", TINY_LOOP_MOTION)
    n = n_lap + TINY_LOOP_MOTION["overrun"]
    gt = render.loop_trajectory(n, **TINY_LOOP_MOTION)
    c = gt[:, 4:].copy()
    if fault == "offset":
        c[n // 2:, 0] += 0.5
    elif fault == "snap":
        o = TINY_LOOP_MOTION["overrun"]
        c[o:n_lap - 1, 0] += 0.8 * np.arange(n_lap - 1 - o) / (n_lap - 1 - o)
    q_cw = gt[:, :4] * np.array([1.0, -1, -1, -1])
    traj = np.zeros((n, 17))
    traj[:, 7:11] = q_cw
    traj[:, 11:14] = -check._qrot(q_cw, c)
    traj[:, 15] = 1.0
    kf = np.zeros((1, 7))
    kf[0, 0] = 1.0
    p = {"fid0": 0, "idx": np.arange(n), "traj": traj, "kf_pose": kf}
    return [p], (lambda _: gt), n_lap, [n_lap]


@pytest.mark.parametrize("fault,correct", [
    (None, True), ("offset", False), ("snap", False)])
def test_junction_faults_make_correct_false(fault, correct):
    """The ground truth meets the limits; a junction 0.5 m off fails them,
    and so does a loop left open that tracking snaps shut in one frame:
    the overrun then matches the lap's start, and only the step tells."""
    passes, gt_of, lap, corrections = truth_pass(fault)
    got = check.loop_numbers(passes, gt_of, lap, corrections)
    (p,) = got["passes"]
    if fault is None:
        assert got["loop_junction_m"] < 1e-9
    if fault == "snap":
        assert p["overrun_m"] < 1e-9 and p["step_row"] == lap - 1
    assert check.judge(got, LOOP_LIMITS)[0] is correct, got
