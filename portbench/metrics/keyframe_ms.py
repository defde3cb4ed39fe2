"""A keyframe's eager insertion (`system.insert_kf`) and all its
integration stages (`system.mapping_stage`) on the window's final warm state: device ms a call (CUDA events
around several calls, after one warm call)."""


def read(rec):
    return rec.get("stage_ms", {}).get("keyframe_ms")
