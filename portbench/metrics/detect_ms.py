"""One eager loop detection (`loopclosing.detect`) over the session's
own keyframe table on the window's final warm state: device ms a call (CUDA events
around several calls, after one warm call)."""


def read(rec):
    return rec.get("stage_ms", {}).get("detect_ms")
