"""The span log (`orb_slam2_tpu_torch/core/spans.py`): nesting, self
time and the ring's bound on made-up spans; on a short eager RGB-D
session on the CPU, that each `frame` span's duration is its
`SLAM.timings` entry, that a reaction carries the frame id of the HUD
entry that raised it, that there are no device intervals, and that the
log turned off records nothing; that `spans.clock` is the clock
torch.profiler stamps host events with.  One card test runs captured
frames under torch.profiler: the graph launches fall inside their
`replay` spans on that clock, and no device event bears a span's name.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import pytest
import torch

from orb_slam2_tpu_torch import config as C
from orb_slam2_tpu_torch.core import spans
from orb_slam2_tpu_torch.io import synthetic
from orb_slam2_tpu_torch.pipeline.system import SLAM

FRAMES = 14
SPAN_NAMES = {"frame", "init", "dispatch", "slot_wait", "capture", "replay",
              "drain", "hud_wait", "reset", "reloc_launch", "reloc_apply",
              "detect_launch", "loop_wait", "verify", "correct", "gba",
              "flush", "stages", "sync", "step"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_rgbd_cfg():
    cam = C.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                         height=240, fps=30.0, bf=16.0, th_depth=35.0)
    return C.SLAMConfig(
        sensor=C.RGBD, camera=cam,
        orb=C.ORBConfig(n_features=500, max_keypoints=512),
        cap=C.Capacity(max_keyframes=96, max_points=6144, max_obs_per_kf=512,
                       max_frames=512, local_ba_points=2048))


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(small_rgbd_cfg().camera, n_frames=FRAMES,
                              n_points=300, trajectory="xyz", seed=0)


def _play(slam, seq, frames):
    for f in frames:
        slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])


@pytest.fixture(scope="module")
def session(seq):
    """A 14-frame eager session and a flush, logged in a log of its own."""
    old, spans.LOG = spans.LOG, spans.Log()
    try:
        slam = SLAM(small_rgbd_cfg(), device="cpu")
        _play(slam, seq, range(FRAMES))
        slam.flush()
        kf_fids = slam.state.kf_frame_id[slam.state.kf_valid].tolist()
        yield slam, spans.LOG, kf_fids
    finally:
        spans.LOG = old


def test_nesting_self_time_and_ring(monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(spans, "clock", lambda: next(ticks))
    monkeypatch.setattr(spans, "RING", 4)
    log = spans.Log()
    with log.span("frame", 7) as fr:
        with log.span("drain"):
            with log.span("hud_wait", 3):
                pass
            with log.span("reset"):
                log.count("drained_keyframe")
    rec = [r for r in log.records if r.name == "frame"][0]
    assert rec.dur_s == fr.dur and rec.parent is None and rec.cause == 7
    drain, wait = rec.sums["drain"], rec.sums["hud_wait"]
    # a tick is 10 ns: drain spans 5 ticks, hud_wait and reset 1 each
    assert wait == [1, 10, 10] and drain == [1, 50, 50 - 10 - 10]
    assert rec.sums["drained_keyframe"][0] == 1
    # `reset` is a record of its own inside the frame, under `drain`
    reset = [r for r in log.records if r.name == "reset"][0]
    assert reset.parent == "drain" and reset.cause == 7
    causes = {s[0]: s[1] for s in log.spans}
    assert causes == {"hud_wait": 3, "drain": 7, "reset": 7, "frame": 7}
    depth = {s[0]: s[4] for s in log.spans}
    assert depth == {"frame": 0, "drain": 1, "hud_wait": 2, "reset": 2}
    for _ in range(10):
        with log.span("flush"):
            pass
    assert len(log.records) == 4
    assert log.summary()["flush"]["calls"] == 10
    assert log.summary()["drain"]["self_ms"] == pytest.approx(30e-6)


def test_frame_span_is_the_timings_entry(session):
    slam, log, _ = session
    frames = [r for r in log.records if r.name == "frame"]
    assert len(frames) == FRAMES == len(slam.timings)
    assert [r.dur_s for r in frames] == slam.timings
    assert [r.cause for r in frames] == list(range(FRAMES))
    assert frames[0].sums.keys() == {"init"}
    for r in frames[1:]:
        assert {"dispatch", "replay", "drain"} <= r.sums.keys()
        assert r.ns("frame") == 0 and r.ns("replay") <= r.ns("dispatch")
        assert not r.profiled
    assert [r.name for r in log.records][-1] == "flush"


def test_a_reaction_carries_its_frame_id(session):
    slam, log, kf_fids = session
    tops = {r.seq: r for r in log.records}
    launches = [s for s in log.spans if s[0] == "detect_launch"]
    assert launches
    for name, cause, t0, t1, depth, top in launches:
        # the keyframe's frame, drained hud_lag frames later (or by flush)
        assert cause in kf_fids
        assert tops[top].name == "flush" or \
            tops[top].cause - cause >= slam.hud_lag
    assert log.counts["drained_keyframe"] >= len(launches)


def test_no_device_intervals_on_the_cpu(session):
    _, log, _ = session
    assert not log.intervals
    assert all(v.get("device_ms") is None for v in log.summary().values())
    assert spans.mark(torch.device("cpu")) is None


def test_the_log_turned_off_records_nothing(seq):
    old, spans.LOG = spans.LOG, spans.Log()
    try:
        spans.enable(False)
        slam = SLAM(small_rgbd_cfg(), device="cpu")
        _play(slam, seq, range(2))
        slam.flush()
        slam.reset()
        assert len(slam.timings) == 2 and min(slam.timings) > 0
        log = spans.LOG
        assert not log.records and not log.spans and not log.totals
        assert not log.counts and log.seq == 0
    finally:
        spans.enable(True)
        spans.LOG = old


def _profiled_ops(prof, name):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name and
            e.device_type() != torch.autograd.DeviceType.CUDA]


def test_clock_is_the_profilers():
    log = spans.Log()
    x = torch.ones(64, 64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with log.span("mm") as sp:
            x @ x
    (mm,) = _profiled_ops(prof, "aten::mm")
    (rec,) = log.records
    assert rec.profiled and sp.dur > 0
    assert rec.t0 <= mm.start_ns() <= mm.end_ns() <= rec.t1


@pytest.mark.cuda
def test_captured_frames_under_the_profiler():
    """Graph launches fall inside their `replay` spans on `spans.clock`;
    the profiler's device timeline holds no span's name; the dispatches'
    device intervals are read, and placed through the capture's
    anchor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs there only")
    cfg = small_rgbd_cfg()
    seq = synthetic.generate(cfg.camera, n_frames=16, n_points=300,
                             trajectory="xyz", seed=0)
    old, spans.LOG = spans.LOG, spans.Log()
    try:
        slam = SLAM(cfg, device="cuda")
        _play(slam, seq, range(12))
        torch.cuda.synchronize()
        seq0 = spans.LOG.seq
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _play(slam, seq, range(12, 16))
            torch.cuda.synchronize()
        slam.flush()
        log = spans.LOG
        replays = [s for s in log.spans if s[0] == "replay" and s[5] > seq0]
        launches = _profiled_ops(prof, "cudaGraphLaunch")
        assert len(replays) == 4 and len(launches) == 4
        for e in launches:
            assert any(s[2] <= e.start_ns() <= s[3] for s in replays)
        device = {e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA}
        assert not device & SPAN_NAMES
        frames = [r for r in log.records if r.name == "frame"]
        assert [r.dur_s for r in frames] == slam.timings
        assert all(r.profiled == (r.seq > seq0) for r in frames)
        dispatch = [iv for iv in log.intervals if iv[0] == "dispatch"]
        assert len(dispatch) == 15
        assert all(iv[5] > 0 for iv in dispatch)
        placed = [iv for iv in dispatch if iv[3] is not None]
        assert len(placed) >= 13
        for (_, _, _, a0, a1, _), (_, _, _, b0, _, _) in zip(placed,
                                                            placed[1:]):
            assert a0 < a1 <= b0 + 10_000    # one stream, in order
    finally:
        spans.LOG = old
