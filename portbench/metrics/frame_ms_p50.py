"""Median host ms of the window's `track_*` calls (`SLAM.timings`)."""

import statistics


def read(rec):
    if rec["mode"] != "session" or not rec["timings_ms"]:
        return None
    return statistics.median(rec["timings_ms"])
