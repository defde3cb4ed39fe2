"""The metric arithmetic, from made-up readings."""

import pytest

from portbench import registry, run, trace


def rec(**kw):
    base = {"mode": "session", "S": 1, "window_s": 2.0, "timings_ms": [],
            "step_ms": []}
    base.update(kw)
    return base


def test_p95_takes_every_frame():
    xs = [1.0] * 95 + [100.0] * 5
    assert run.p95(xs) == pytest.approx(95.05)
    assert run.p95(list(range(1, 101))) == pytest.approx(95.95)


def test_frame_ms_p50_is_the_median():
    r = registry.reader("frame_ms_p50")
    assert r(rec(timings_ms=[3.0, 1.0, 2.0, 50.0, 4.0])) == 3.0
    assert r(rec(mode="dp", timings_ms=[1.0])) is None


def test_idle_share_from_event_spans():
    """From the profiler window's busy intervals (their union's length)
    over the traced span."""
    r = registry.reader("device_idle_share")
    # 1.5 s busy in a 2 s trace: 25 % idle
    prof = {"kernels": {}, "frames": 10, "busy_s": 1.5, "trace_s": 2.0}
    assert r(rec(profile=prof)) == pytest.approx(25.0)
    assert r(rec()) is None


def test_dp_step_p95_needs_a_window_of_steps():
    r = registry.reader("dp.step_ms_p95")
    steps = [10.0] * 95 + [60.0] * 5
    assert r(rec(mode="dp", step_ms=steps)) == pytest.approx(57.5)
    assert r(rec(mode="dp", step_ms=[10.0] * 5)) is None


def test_fast_roofline_from_shapes():
    bound, by = trace.fast_bound_s(480, 640, 8, 1.2, 1)
    levels = trace.level_shapes(480, 640, 8, 1.2)
    px = sum(h * w for h, w in levels)
    nbytes = px * 4 + 8 * 480 * 640 * 8
    assert by == "bytes"
    assert bound == pytest.approx(nbytes / 3.35e12)
    r = registry.reader("fast_nms_roofline")
    prof = {"kernels": {"void fast_nms_atlas_kernel<8>(float*)":
                        [10, 10 * 2 * bound]}, "frames": 10}
    assert r(rec(profile=prof, fast_bound_s=bound)) == pytest.approx(50.0)
    assert r(rec(profile={"kernels": {}, "frames": 10},
                 fast_bound_s=bound)) is None


def test_kernels_and_pose_lm_per_frame():
    prof = {"kernels": {"pose_lm_kernel": [20, 0.004], "gemm": [180, 0.01]},
            "frames": 10}
    assert registry.reader("kernels_per_frame")(rec(profile=prof)) == 20.0
    assert registry.reader("pose_lm_ms")(rec(profile=prof)) == \
        pytest.approx(0.4)


def test_dp_phases_sum_insert_and_stage():
    ph = {"extract": 11.0, "track": 4.0, "insert": 2.0, "stage": 9.0}
    assert registry.reader("dp.map_ms")(rec(dp_phase_ms=ph)) == 11.0
    assert registry.reader("dp.extract_ms")(rec(dp_phase_ms=ph)) == 11.0
    assert registry.reader("dp.track_ms")(rec()) is None
