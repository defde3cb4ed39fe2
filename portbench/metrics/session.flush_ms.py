"""Host ms of the window's top-level `flush` and `reset` records (the
pass boundaries, the closing flush among them) over the window's frames;
from the program's span log (`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    if w is None:
        return None
    s = sum(r.dur_s for r in w.records if r.name in ("flush", "reset"))
    return s * 1e3 / len(w.frames)
