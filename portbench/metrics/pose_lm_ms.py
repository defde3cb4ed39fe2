"""Device ms of the pose-LM kernel a frame (dp: a frame of one sequence)
in the profiler window."""

KERNEL = "pose_lm_kernel"


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    s = sum(v[1] for k, v in prof["kernels"].items() if KERNEL in k)
    if s <= 0:
        return None
    return s * 1e3 / prof["frames"]
