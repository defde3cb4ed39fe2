"""95th percentile of the captured dp steps' device spans (a CUDA event
after each step of the traced window; the card runs the steps back to
back)."""

import statistics


def read(rec):
    xs = rec["step_ms"] if rec["mode"] == "dp" else []
    if len(xs) < 20:
        return None
    return statistics.quantiles(xs, n=20)[18]
