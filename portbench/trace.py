"""Device timing and the profiler window's reduction.

Frozen copies, each from where it is marked: `charge` (from
orb_slam2_tpu_torch/dp_profile.py); the H100 peaks and the FAST-9+NMS
operations and bytes (from chip_smoke.py).  The rest reduces a
torch.profiler trace to what the per-layer readers and the result's
`device` and `breakdown` take: kernels by name, the union of device busy
intervals, and the idle gaps labelled by what the host was doing.

After a torch.profiler trace CUPTI stays attached and every CUDA graph
launch blocks the host, so a run times nothing after its profiler window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
# (copied from chip_smoke.py)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST-9 + NMS arithmetic per level pixel, counted from csrc/fast_nms.cu
# (copied from chip_smoke.py): 16 differences; bright and dark arcs each 44
# min/max for the 16 windows of 9 plus 15 max/min over them; the final 2
# max; 8 NMS max + 1 compare
FAST_OPS_PER_PX = 16 + 2 * (44 + 15) + 2 + 9
# bytes: every level pixel read once (4 B); both padded [G, Hp, Wp] maps
# written once (2 x 4 B a plane pixel)
FAST_IN_BYTES_PER_PX = 4
FAST_OUT_BYTES_PER_PLANE_PX = 8


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(n_levels)]


def fast_bound_s(height: int, width: int, n_levels: int, scale: float,
                 n_images: int) -> Tuple[float, str]:
    """The least time one FAST-9+NMS launch over n_images images' level
    atlases can take on an H100: the larger of its bytes over HBM's rate
    and its f32 operations over the non-tensor peak; and which bounds."""
    levels = level_shapes(height, width, n_levels, scale)
    px = n_images * sum(h * w for h, w in levels)
    planes = n_levels * n_images
    nbytes = px * FAST_IN_BYTES_PER_PX + \
        planes * height * width * FAST_OUT_BYTES_PER_PLANE_PX
    b = nbytes / PEAK_BYTES_PER_S
    o = px * FAST_OPS_PER_PX / PEAK_F32_OPS_PER_S
    return max(b, o), "bytes" if b >= o else "operations"


def charge(prof, label: str, phases) -> dict:
    """{phase: [device us, device events]} of a finished trace whose phase
    ranges are named `label` + phase, with "other" for the events launched
    outside the ranges and "unattributed" for those whose launch the trace
    does not show (copied from dp_profile.py `charge`)."""
    dev_t = torch.autograd.DeviceType.CUDA
    ranges, runtime, ops, device = [], {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == dev_t:
            if not e.name().startswith(label):
                device.append(e)
            continue
        name = e.name()
        if name.startswith(label):
            ranges.append((e.start_ns(), e.end_ns(), name[len(label):]))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = {p: [0.0, 0] for p in tuple(phases) + ("other", "unattributed")}
    for e in device:
        t = runtime.get(e.correlation_id())
        if t is None:
            t = ops.get(e.linked_correlation_id())
        if t is None:
            phase = "unattributed"
        else:
            i = bisect.bisect_right(starts, t) - 1
            phase = ranges[i][2] if i >= 0 and t <= ranges[i][1] else "other"
        out[phase][0] += e.duration_ns() / 1e3
        out[phase][1] += 1
    return out


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_profile(prof, top: int = 10) -> dict:
    """From a finished torch.profiler trace: kernels by name ({name:
    [count, device s]}), the device's busy seconds (the union of its
    kernels', copies' and fills' intervals), the traced window's length
    (first to last event, host or device), the top device operations
    and the longest idle gaps summed by the host operation that was
    running when each began (the innermost one)."""
    dev_t = torch.autograd.DeviceType.CUDA
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    dev_iv, host_ev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == dev_t:
            if e.duration_ns() <= 0 or e.name().startswith("dp_phase/"):
                continue
            k = kernels[e.name()]
            k[0] += 1
            k[1] += e.duration_ns() / 1e9
            dev_iv.append((e.start_ns(), e.end_ns()))
        else:
            host_ev.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _merged(dev_iv)
    busy_s = sum(e - s for s, e in busy) / 1e9
    ends = [h[1] for h in host_ev] + [e for _, e in dev_iv]
    begins = [h[0] for h in host_ev] + [s for s, _ in dev_iv]
    trace_s = (max(ends) - min(begins)) / 1e9 if ends else 0.0
    host_ev.sort()
    starts = [h[0] for h in host_ev]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        # the innermost host operation open when the gap began: the one
        # that started last among those still running
        label = "no host op"
        i = bisect.bisect_right(starts, e0) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host_ev[j][1] >= e0:
                label = host_ev[j][2]
                break
        gaps[label] += (s1 - e0) / 1e9
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    idle = sorted(([n, s] for n, s in gaps.items()),
                  key=lambda kv: -kv[1])[:top]
    return {"kernels": {n: list(v) for n, v in kernels.items()},
            "busy_s": busy_s, "trace_s": trace_s,
            "device_ops": ops, "idle_gaps": idle}


def profile(run):
    """Run `run()` under torch.profiler (host and device activity) with a
    synchronisation at the end; returns the finished profiler."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    return prof
