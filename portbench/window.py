"""The timed window in the program's span log, for the `program_span`
readers of `metrics/`.

The program (`orb_slam2_tpu_torch/core/spans.py`) keeps a record of
each `track_*` call (`frame`), each dp step (`step`), each top-level
`flush` and `reset` and each `capture`, with the sums of the spans
inside it, and device intervals read from CUDA events it already waits
on.  A reader runs in the program's process once the run is over
(`run.run_cell`), so it reads that process's log.

The window: the last `len(rec["timings_ms"])` frame (dp: step) records
made while no torch.profiler was recording, and the top-level records
from the first of them through the flush that closes the window (every
unprofiled one before the next profiled record); the device intervals
the log has not read yet, and that have finished, are read first.  There
is no window (None) when the log is missing (a program without it), when
a session's frame durations x 1e3 are not `rec["timings_ms"]` element by
element, or when the window holds no device interval (a run without a
card).
"""

from __future__ import annotations

import statistics
from typing import List, NamedTuple, Optional

# the session's reactions: each a span inside a frame's `drain` (`init`
# outside it), put down to the frame whose HUD entry raised it
REACTIONS = ("init", "reset", "reloc_launch", "reloc_apply", "detect_launch",
             "loop_wait", "verify", "correct", "gba")


class Window(NamedTuple):
    frames: list         # the frame (dp: step) records
    records: list        # every top-level record of the window
    intervals: list      # (name, cause, record seq, t0, t1, device ms)
    log: object          # the span log


def program_log():
    """The program's span log, or None when the program has none."""
    try:
        from orb_slam2_tpu_torch.core import spans
    except ImportError:
        return None
    return getattr(spans, "LOG", None)


def select(rec: dict, log=None) -> Optional[Window]:
    log = log if log is not None else program_log()
    n = len(rec["timings_ms"])
    if log is None or n == 0:
        return None
    name = "step" if rec["mode"] == "dp" else "frame"
    top = [r for r in log.records if r.parent is None]
    idx = [i for i, r in enumerate(top) if r.name == name and not r.profiled]
    if len(idx) < n:
        return None
    records = []
    for r in top[idx[-n]:]:
        if r.profiled:
            break
        records.append(r)
    frames = [r for r in records if r.name == name]
    if frames != [top[i] for i in idx[-n:]]:
        return None
    if rec["mode"] != "dp" and \
            [r.dur_s * 1e3 for r in frames] != list(rec["timings_ms"]):
        return None
    # the last dp steps' intervals wait for a next step to be read: the
    # run's closing synchronisation has finished them
    log.ready()
    seqs = {r.seq for r in records}
    intervals = [iv for iv in log.intervals if iv[2] in seqs]
    if not intervals:
        return None
    return Window(frames, records, intervals, log)


def frame_ms(w: Window, names, self_time: bool = False) -> float:
    """Host ms a window frame spent in the spans `names` (their self
    time with `self_time`)."""
    ns = sum(r.ns(k, self_time) for r in w.frames for k in names)
    return ns / 1e6 / len(w.frames)


def device_ms(w: Window, name: str) -> List[float]:
    """The device ms of each of the window's intervals called `name`."""
    return [iv[5] for iv in w.intervals if iv[0] == name]


def p95(xs: List[float]) -> Optional[float]:
    return statistics.quantiles(xs, n=20)[18] if len(xs) >= 20 else None


def busy_s(w: Window, window_s: float) -> float:
    """Seconds the card ran the window's device intervals: their union
    on the host clock, over the `window_s` seconds from the window's
    first record (the card may finish a dp window's steps after the host
    has issued the last one), when every one is placed there, else their
    sum (one stream runs them one after another)."""
    ivs = w.intervals
    if any(iv[3] is None for iv in ivs):
        return sum(iv[5] for iv in ivs) / 1e3
    lo = w.records[0].t0
    hi = lo + round(window_s * 1e9)
    total, end = 0, lo
    for a, b in sorted((max(iv[3], lo), min(iv[4], hi)) for iv in ivs):
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total / 1e9
