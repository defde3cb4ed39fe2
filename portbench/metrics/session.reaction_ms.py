"""Host self ms a window frame spent in the session's reactions (`init`,
`reset`, `reloc_launch`, `reloc_apply`, `detect_launch`, `loop_wait`,
`verify`, `correct`, `gba`); from the program's span log
(`window.py`)."""

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    if w is None:
        return None
    return window.frame_ms(w, window.REACTIONS, self_time=True)
