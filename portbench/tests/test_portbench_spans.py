"""The `program_span` readers of the program's span log (`window.py`),
from made-up logs: the window's selection (profiled records after it left
out, the closing flush taken in), None on a timings mismatch, without a
log or without device intervals, `window_idle_share` from made-up
intervals, and each metric's arithmetic."""

import pytest

from orb_slam2_tpu_torch.core import spans
from portbench import registry, window

MS = 1_000_000          # ns


class Made:
    """A made-up log: records appended in order, one ms apart, each
    `dur` ms long; a frame's sums and device intervals as given."""

    def __init__(self):
        self.log = spans.Log()
        self.t = 0

    def add(self, name, dur=1.0, profiled=False, sums=None, parent=None,
            device=(), cause=None):
        log = self.log
        log.seq += 1
        r = spans.Record(log.seq, name, cause, parent, self.t, profiled)
        r.t1 = self.t + round(dur * MS)
        r.dur_s = dur / 1e3
        r.sums = {k: [1, round(v * MS), round(s * MS)]
                  for k, (v, s) in (sums or {}).items()}
        for iname, a, b in device:
            log.intervals.append((iname, cause, log.seq,
                                  self.t + round(a * MS),
                                  self.t + round(b * MS), b - a))
        log.records.append(r)
        self.t = r.t1 + MS
        return r


def session_log(window_frames=4):
    """2 warm-up frames (the first with a capture inside), a reset, the
    window's frames with a pass boundary (flush, reset) among them and
    the closing flush, then 2 profiled frames and a profiled flush."""
    m = Made()
    m.add("capture", 500.0, parent="dispatch")
    m.add("frame", 600.0, device=[("dispatch", 0.1, 3.0)])
    m.add("frame", 5.0, device=[("dispatch", 0.1, 3.0)])
    m.add("flush", 50.0)
    m.add("reset", 2.0)
    frames = []
    for k in range(window_frames):
        sums = {"dispatch": (3.0, 0.5), "replay": (2.0, 2.0),
                "drain": (4.0, 0.5), "hud_wait": (1.5, 1.5),
                "detect_launch": (2.0, 2.0)}
        if k == 1:
            sums["verify"] = (40.0, 40.0)
        frames.append(m.add("frame", 8.0 + k, sums=sums, cause=10 + k,
                            device=[("dispatch", 0.2, 3.2 + k)]))
        if k == 1:
            m.add("flush", 20.0, device=[("stages", 1.0, 11.0)])
            m.add("reset", 3.0)
    m.add("flush", 10.0)
    m.add("frame", 7.0, profiled=True, device=[("dispatch", 0.2, 3.0)])
    m.add("frame", 7.0, profiled=True)
    m.add("flush", 9.0, profiled=True)
    return m.log, frames


def rec_of(frames, **kw):
    base = {"mode": "session", "S": 1, "window_s": 0.2, "step_ms": [],
            "timings_ms": [r.dur_s * 1e3 for r in frames]}
    base.update(kw)
    return base


@pytest.fixture
def made(monkeypatch):
    log, frames = session_log()
    monkeypatch.setattr(spans, "LOG", log)
    return log, frames


def test_the_window_is_the_last_unprofiled_frames_and_the_closing_flush(
        made):
    log, frames = made
    w = window.select(rec_of(frames))
    assert w.frames == frames
    names = [r.name for r in w.records]
    assert names == ["frame", "frame", "flush", "reset", "frame", "frame",
                     "flush"]
    assert not any(r.profiled for r in w.records)
    # the dispatches of the window's frames and the boundary's stages
    assert [iv[0] for iv in w.intervals] == ["dispatch"] * 2 + ["stages"] + \
        ["dispatch"] * 2


def test_no_window_on_a_timings_mismatch_or_without_a_log(made,
                                                          monkeypatch):
    log, frames = made
    rec = rec_of(frames)
    rec["timings_ms"][2] += 1e-9
    assert window.select(rec) is None
    # more timings than unprofiled frames
    assert window.select(rec_of(frames * 3)) is None
    for name in ("session.hud_wait_ms", "window_idle_share", "capture_s"):
        assert registry.reader(name)(rec) is None
    monkeypatch.setattr(window, "program_log", lambda: None)
    assert registry.reader("session.flush_ms")(rec_of(frames)) is None


def test_no_window_without_device_intervals(made):
    log, frames = made
    log.intervals.clear()
    assert window.select(rec_of(frames)) is None


def test_session_metrics(made):
    log, frames = made
    rec = rec_of(frames)
    read = lambda name: registry.reader(name)(rec)
    assert read("session.hud_wait_ms") == pytest.approx(1.5)
    # self ms of detect_launch (2.0) each frame, verify (40.0) in one of 4
    assert read("session.reaction_ms") == pytest.approx(2.0 + 40.0 / 4)
    assert read("loop.verify_ms") == pytest.approx(10.0)
    # the boundary's flush and reset and the closing flush over 4 frames
    assert read("session.flush_ms") == pytest.approx((20 + 3 + 10) / 4)
    # dispatch device ms 3.0, 4.0, 5.0, 6.0
    assert read("session.step_device_ms") == pytest.approx(4.5)
    assert read("session.step_device_ms_p95") is None     # < 20 of them
    assert read("capture_s") == pytest.approx(0.5)
    assert read("frame_ms_p50") == pytest.approx(9.5)


def test_verify_ms_is_zero_when_nothing_was_verified(monkeypatch):
    log, frames = session_log()
    for r in frames:
        r.sums.pop("verify", None)
    monkeypatch.setattr(spans, "LOG", log)
    assert registry.reader("loop.verify_ms")(rec_of(frames)) == 0.0


def test_step_device_p95_over_twenty_dispatches(monkeypatch):
    log, frames = session_log(window_frames=40)
    monkeypatch.setattr(spans, "LOG", log)
    rec = rec_of(frames)
    xs = [3.0 + k for k in range(40)]
    assert registry.reader("session.step_device_ms_p95")(rec) == \
        pytest.approx(window.p95(xs))
    assert window.p95(xs) == pytest.approx(40.95)


def test_window_idle_share_from_made_up_intervals(made):
    log, frames = made
    w = window.select(rec_of(frames))
    lo, hi = w.records[0].t0, w.records[-1].t1
    span_s = (hi - lo) / 1e9
    # the placed intervals are disjoint: their union is their sum
    busy = sum(iv[4] - iv[3] for iv in w.intervals) / 1e9
    assert window.busy_s(w, span_s) == pytest.approx(busy)
    rec = rec_of(frames, window_s=span_s)
    share = registry.reader("window_idle_share")(rec)
    assert share == pytest.approx(100 * (1 - busy / span_s))
    # overlapping, before the window and past its end: counted once and
    # only inside the window_s seconds from its first record
    log.intervals.append(("stages", None, frames[0].seq,
                          frames[0].t0 - 5 * MS, frames[0].t0 + 2 * MS, 7.0))
    log.intervals.append(("dispatch", None, frames[0].seq, hi - MS,
                          hi + 9 * MS, 10.0))
    w = window.select(rec)
    # frame 0's dispatch ran 0.2-3.2 ms into it: the new one adds 0-0.2
    assert window.busy_s(w, span_s) == pytest.approx(busy + 0.2e-3 + 1e-3)
    assert window.busy_s(w, span_s + 4e-3) == pytest.approx(
        busy + 0.2e-3 + 5e-3)
    # an interval with no anchor: the sum of the device ms
    log.intervals.append(("dispatch", None, frames[0].seq, None, None, 1.0))
    w = window.select(rec)
    total = sum(iv[5] for iv in w.intervals) / 1e3
    assert window.busy_s(w, span_s) == pytest.approx(total)


def test_dp_window_takes_steps_without_a_timings_check(monkeypatch):
    m = Made()
    m.add("init", 30.0, device=[("init", 0.0, 20.0)])
    m.add("step", 900.0, cause=0, device=[("step", 0.0, 800.0)])
    # the card finishes the last step 11 ms after the host issued it,
    # inside the window (its closing synchronisation)
    steps = [m.add("step", 50.0, cause=k,
                   device=[("step", 1.0, 41.0 if k < 4 else 61.0)])
             for k in range(1, 5)]
    m.add("step", 50.0, profiled=True, device=[("step", 1.0, 41.0)])
    monkeypatch.setattr(spans, "LOG", m.log)
    rec = {"mode": "dp", "S": 8, "window_s": (steps[-1].t1 - steps[0].t0)
           / 1e9 + 0.011, "timings_ms": [49.0] * 4, "step_ms": []}
    w = window.select(rec)
    assert w.frames == steps
    assert registry.reader("window_idle_share")(rec) == pytest.approx(
        100 * (1 - 0.180 / rec["window_s"]))
    assert registry.reader("session.hud_wait_ms")(rec) is None
    assert registry.reader("capture_s")(rec) is None    # none captured


class FinishedEvent:
    """A CUDA event stand-in that has run, at `t` ns of the host clock."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / MS


def test_finished_intervals_not_read_yet_are_read(made):
    """A dp window's last steps are read by no later step: the window
    reads the log's finished queue first."""
    log, frames = made
    last = frames[-1]
    a, b = FinishedEvent(last.t0 + MS), FinishedEvent(last.t0 + 4 * MS)
    anchor = (FinishedEvent(0), 0)
    log._pending.append(("dispatch", last.cause, last.seq,
                         (a, False, anchor), b))
    w = window.select(rec_of(frames))
    assert not log._pending
    assert w.intervals[-1] == ("dispatch", last.cause, last.seq,
                               last.t0 + MS, last.t0 + 4 * MS, 3.0)
