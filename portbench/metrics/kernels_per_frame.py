"""Device kernels in the profiler window a frame (dp: a frame of one
sequence)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["kernels"]:
        return None
    return sum(v[0] for v in prof["kernels"].values()) / prof["frames"]
