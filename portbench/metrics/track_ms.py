"""The eager tracking step (`tracking.build_track_step`) on the window's final warm state: device ms a call (CUDA events
around several calls, after one warm call)."""


def read(rec):
    return rec.get("stage_ms", {}).get("track_ms")
