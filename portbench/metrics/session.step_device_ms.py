"""Median device ms of a window dispatch: CUDA events from before its
input copies to after its HUD copy (the replay between them), read where
the session waits on the HUD; no profiler.  From the program's span log
(`window.py`)."""

import statistics

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    xs = [] if w is None else window.device_ms(w, "dispatch")
    return statistics.median(xs) if xs else None
