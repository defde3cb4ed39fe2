"""The eager frame construction (`SLAM._frame_fn`: extraction, and the
stereo match or the depth lookup) on the window's final warm state: device ms a call (CUDA events
around several calls, after one warm call)."""


def read(rec):
    return rec.get("stage_ms", {}).get("extract_ms")
