"""Share of the timed window (%) in which the card ran none of the
window's device intervals (the session's dispatches, reactions and
flushes; the dp steps): 100 x (1 - their union / `window_s`), with no
profiler attached.  From the program's span log (`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec)
    if w is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s(w, rec["window_s"]) /
                     rec["window_s"])
