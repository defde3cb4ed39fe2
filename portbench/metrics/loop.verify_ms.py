"""Host ms a window frame spent in `verify` (`loopclosing.verify`, the
Sim3 verification of a consistent loop candidate, on the host); 0.0 when
no candidate reached it.  From the program's span log (`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    return None if w is None else window.frame_ms(w, ("verify",))
