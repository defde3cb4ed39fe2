"""95th percentile of the window dispatches' device ms (as
`session.step_device_ms`; 20 dispatches or more)."""

from portbench import window


def read(rec):
    w = window.select(rec) if rec["mode"] == "session" else None
    return None if w is None else window.p95(window.device_ms(w, "dispatch"))
