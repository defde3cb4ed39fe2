"""The span log: host spans at the session's and the dp step's layer
boundaries, host counts at the same places, and device intervals from
CUDA events that the program already waits on.

A span has a name, its start and end on `clock`, its parent (the span
open when it began) and a cause: the frame id (session) or the step
number (dp) whose work it serves; a span given no cause takes its
parent's.  `clock` is the clock torch.profiler stamps its host events
with (`tests/test_torch_spans.py` checks it on the CPU and on the card),
so the log and a profiler trace share one timeline.

A top-level span, and any span named in `RECORDS`, closes into a
record: a sequence number, name, cause, start, end, its duration in
seconds (`dur_s`, the float `SLAM.timings` gets for a `frame`), its
parent's name, whether a torch.profiler was recording when it began,
and the sums of every span inside it ({name: [calls, host ns, self
ns]}; self time leaves out the spans inside).  The last `RING` records
and `SPAN_RING` closed spans are kept; running totals beside them
(`summary()`) cover the whole process.

Device intervals: `mark` records a timing event where a span's device
work begins, `interval` queues it with the event the program records
after that work, and the pair is read (`elapsed_time`) only where the
program already waits: `waited(ev)` after a wait on `ev`, `synced(dev)`
after a synchronisation, `ready()` for the pairs that have finished.
Nothing here synchronises.  `synced` also records the device's anchor,
an event with its host time, through which each interval is placed on
`clock`, so that an idle stretch of the card can be put down to the
host span open at the time (`idle_by_span`).  On the CPU there are no
intervals.

Nothing here is a `record_function` range: a profiler would put such
ranges on the device timeline.  Spans are on in every run;
`enable(False)` turns the log off (to measure what it costs).
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

clock = time.time_ns
RING = 1 << 16              # records kept
SPAN_RING = 1 << 17         # closed spans kept
RECORDS = frozenset(("frame", "flush", "reset", "capture", "step"))


class Record:
    """One top-level span (or one named in RECORDS) and the sums of the
    spans inside it."""

    __slots__ = ("seq", "name", "cause", "parent", "t0", "t1", "dur_s",
                 "profiled", "sums")

    def __init__(self, seq, name, cause, parent, t0, profiled):
        self.seq, self.name, self.cause, self.parent = seq, name, cause, parent
        self.t0, self.t1, self.dur_s = t0, None, None
        self.profiled = profiled
        self.sums: Dict[str, List[int]] = {}

    def ns(self, name: str, self_time: bool = False) -> int:
        """Host ns of the spans called `name` inside this record (their
        self time with `self_time`)."""
        s = self.sums.get(name)
        return 0 if s is None else s[2 if self_time else 1]


class Span:
    """`with log.span(name, cause, device):` — see the module's
    docstring.  `dur` holds the span's seconds once it has closed."""

    __slots__ = ("log", "name", "cause", "device", "t0", "child", "rec",
                 "top", "live", "start", "dur")

    def __init__(self, log, name, cause, device):
        self.log, self.name, self.cause, self.device = log, name, cause, device

    def __enter__(self):
        log = self.log
        self.live = log.on
        if self.live:
            st = log.stack
            if self.cause is None and st:
                self.cause = st[-1].cause
            self.child = 0
            self.rec = None
            if not st or self.name in RECORDS:
                log.seq += 1
                self.rec = Record(log.seq, self.name, self.cause,
                                  st[-1].name if st else None, 0,
                                  torch.autograd._profiler_enabled())
                log.open.append(self.rec)
            self.top = log.open[0].seq
            st.append(self)
            self.start = None
            if self.device is not None:
                self.start = log.mark(self.device)
        self.t0 = clock()
        if self.live and self.rec is not None:
            self.rec.t0 = self.t0
        return self

    def __exit__(self, *exc):
        if self.live and self.start is not None:
            end = self.log._event()
            end.record()
            self.log.interval(self.name, self.cause, self.start, end)
        t1 = clock()
        d = t1 - self.t0
        self.dur = d / 1e9
        if self.live and self.log.stack and self.log.stack[-1] is self:
            self.log._close(self, t1, d)
        return False


class Log:
    """The process's span log (`LOG`); a test may make its own."""

    def __init__(self):
        self.on = True
        self.stack: List[Span] = []          # open spans, outermost first
        self.open: List[Record] = []         # their open records
        self.records: deque = deque(maxlen=RING)
        # closed spans: (name, cause, t0, t1, depth, top-level record seq)
        self.spans: deque = deque(maxlen=SPAN_RING)
        # placed device intervals: (name, cause, top-level record seq,
        # t0, t1 on `clock` or None without an anchor, device ms)
        self.intervals: deque = deque(maxlen=RING)
        # name: [calls, host ns, self ns, device ms (None: no interval)]
        self.totals: Dict[str, list] = {}
        self.counts: Dict[str, int] = {}
        self.seq = 0
        self._pending: deque = deque()       # intervals not read yet
        self._free: List[torch.cuda.Event] = []
        self._anchor: Dict[torch.device, Tuple[torch.cuda.Event, int]] = {}

    # -- host spans and counts ------------------------------------------
    def span(self, name: str, cause: Optional[int] = None,
             device: Optional[torch.device] = None) -> Span:
        """A span; with a CUDA `device`, also a device interval of the
        work queued inside it."""
        if device is not None and device.type != "cuda":
            device = None
        return Span(self, name, cause, device)

    def _close(self, sp: Span, t1: int, d: int):
        self.stack.pop()
        own = d - sp.child
        if self.stack:
            self.stack[-1].child += d
        name = sp.name
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = [0, 0, 0, None]
        tot[0] += 1
        tot[1] += d
        tot[2] += own
        for rec in self.open:
            if rec is sp.rec:
                continue
            s = rec.sums.get(name)
            if s is None:
                rec.sums[name] = [1, d, own]
            else:
                s[0] += 1
                s[1] += d
                s[2] += own
        self.spans.append((name, sp.cause, sp.t0, t1, len(self.stack),
                           sp.top))
        rec = sp.rec
        if rec is not None:
            rec.t1, rec.dur_s = t1, sp.dur
            self.open.pop()
            self.records.append(rec)

    def count(self, name: str, n: int = 1):
        """Add n to the host count `name` (and to the open records')."""
        if not self.on:
            return
        self.counts[name] = self.counts.get(name, 0) + n
        for rec in self.open:
            s = rec.sums.get(name)
            if s is None:
                rec.sums[name] = [n, 0, 0]
            else:
                s[0] += n

    # -- device intervals -----------------------------------------------
    def _event(self) -> torch.cuda.Event:
        """A timing event from the pool (made once, reused once read)."""
        return self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)

    def mark(self, device: torch.device, ev=None, stream=None):
        """Record `ev` (a timing event; one from the pool by default) on
        `stream` (by default the current one) where a span's device work
        begins; returns the mark `interval` takes (None when the log is
        off or the device is not a card)."""
        if not self.on or device.type != "cuda":
            return None
        pooled = ev is None
        ev = self._event() if pooled else ev
        ev.record(stream)
        return ev, pooled, self._anchor.get(device)

    def interval(self, name: str, cause, start, end: torch.cuda.Event):
        """Queue the device interval from the mark `start` to the event
        `end` (recorded after the work, on the same stream), charged to
        the open top-level record; read later, where the program waits."""
        if start is None or not self.on:
            return
        top = self.open[0].seq if self.open else None
        self._pending.append((name, cause, top, start, end))

    def _read(self, item):
        name, cause, top, (a, pooled, anchor), b = item
        ms = a.elapsed_time(b)
        t0 = t1 = None
        if anchor is not None:
            t0 = anchor[1] + round(anchor[0].elapsed_time(a) * 1e6)
            t1 = t0 + round(ms * 1e6)
        self.intervals.append((name, cause, top, t0, t1, ms))
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = [0, 0, 0, None]
        tot[3] = ms if tot[3] is None else tot[3] + ms
        if pooled:
            self._free.extend((a, b))

    def waited(self, ev: torch.cuda.Event):
        """The program has waited on `ev`: read every queued interval up to
        the one that ends at it (the stream ran them in order)."""
        q = self._pending
        for i, item in enumerate(q):
            if item[4] is ev:
                for _ in range(i + 1):
                    self._read(q.popleft())
                return

    def ready(self):
        """Read the queued intervals that have finished (no wait)."""
        q = self._pending
        while q and q[0][4].query():
            self._read(q.popleft())

    def synced(self, device: torch.device):
        """The program has synchronised `device`: read every queued
        interval and record the device's anchor here."""
        if device.type != "cuda":
            return
        while self._pending:
            self._read(self._pending.popleft())
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._anchor[device] = (ev, clock())

    # -- reading --------------------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """name -> calls, host ms, self ms and device ms (None without a
        device interval) of every span since the process began; a host
        count -> its calls."""
        out = {name: {"calls": c, "host_ms": ns / 1e6, "self_ms": own / 1e6,
                      "device_ms": ms}
               for name, (c, ns, own, ms) in self.totals.items()}
        for name, n in self.counts.items():
            out[name] = {"calls": n}
        return out

    def idle_by_span(self, t0: int, t1: int) -> Dict[str, float]:
        """Seconds between t0 and t1 (on `clock`) in which no placed
        device interval ran, each idle stretch put down to the innermost
        span open when it began ("no span" outside every span)."""
        busy = merged([(a, b) for _, _, _, a, b, _ in self.intervals
                       if a is not None and b > t0 and a < t1])
        # (start, depth, end, name): of spans that start together the
        # inner one sorts later
        spans = sorted((s[2], s[4], s[3], s[0]) for s in self.spans
                       if s[3] >= t0 and s[2] <= t1)
        starts = [s[0] for s in spans]
        out: Dict[str, float] = {}
        edge = t0
        for a, b in busy + [(t1, t1)]:
            a = max(a, t0)
            if a > edge:
                label = "no span"
                # back from the last span begun by then, to the first
                # top-level span that had ended (nothing before it is open)
                for j in range(bisect.bisect_right(starts, edge) - 1, -1, -1):
                    s0, depth, s1, name = spans[j]
                    if s1 >= edge:
                        label = name
                        break
                    if depth == 0:
                        break
                out[label] = out.get(label, 0.0) + (a - edge) / 1e9
            edge = max(edge, min(b, t1))
        return out


def merged(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


LOG = Log()


def span(name: str, cause: Optional[int] = None,
         device: Optional[torch.device] = None) -> Span:
    return LOG.span(name, cause, device)


def count(name: str, n: int = 1):
    LOG.count(name, n)


def mark(device: torch.device, ev=None, stream=None):
    return LOG.mark(device, ev, stream)


def interval(name: str, cause, start, end):
    LOG.interval(name, cause, start, end)


def waited(ev):
    LOG.waited(ev)


def ready():
    LOG.ready()


def synced(device: torch.device):
    LOG.synced(device)


def summary() -> Dict[str, dict]:
    return LOG.summary()


def enable(on: bool = True):
    """Turn the process's log on or off (spans open when it changes close
    without a record)."""
    LOG.on = bool(on)
