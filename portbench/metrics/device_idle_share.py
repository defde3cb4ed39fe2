"""Share of the profiler window (%) in which the card ran no operation:
1 minus the union of the device's busy intervals over the traced span
(`device.busy_s` / `device.window_s`).  CUPTI, once attached, makes each
graph launch block the host, so this reads the idle of a profiled
window: high against an unprofiled one, and comparable only between
profiled windows."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["trace_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["trace_s"])
