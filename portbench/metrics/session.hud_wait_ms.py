"""Host ms a window frame blocked in `hud_wait`: the session waiting on
a staging slot's event for the HUD `hud_lag` frames late (the card
holding the host back); from the program's span log (`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    return None if w is None else window.frame_ms(w, ("hud_wait",))
