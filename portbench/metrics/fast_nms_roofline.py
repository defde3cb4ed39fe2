"""FAST-9+NMS's share of its roofline, %: the least time one launch over
the cell's level atlases can take on an H100 (trace.fast_bound_s: the
larger of its bytes over HBM's rate and its operations over the f32 peak)
over the kernel's device time a launch in the profiler window."""

KERNEL = "fast_nms_atlas_kernel"


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    hits = [v for k, v in prof["kernels"].items() if KERNEL in k]
    n = sum(v[0] for v in hits)
    s = sum(v[1] for v in hits)
    if n == 0 or s <= 0:
        return None
    return 100.0 * rec["fast_bound_s"] / (s / n)
