"""The EuRoC stereo example path on the card over rooms of several depth
ranges: where the close-point keyframe condition (`need_close`,
`pipeline/tracking.py`) fires.

    python3 scripts/euroc_close_sweep.py [--ranges 1.0,8.0 1.3,4.5 ...] \
        [--mono]

from the repository root, on a machine with a CUDA card and nvcc.  For
each (near, far) depth range of `io/synthetic.generate`'s room it renders
`chip_smoke.py`'s EuRoC scene (`euroc_eye`: the rectified pair at the
reference's LEFT.P / RIGHT.P, written as raw distorted cam0/cam1 images)
and runs `chip_smoke.py` phase 23 on it (`phase_example`: the CLI's
`run --dataset euroc --sensor stereo` with the reference's EuRoC.yaml),
printing its line: tracked frames, metric ATE, keyframes, the frames
need_close fired on and the close depth points made.  With `--mono` also
phase 24 (cam0 with the reference's monocular EuRoC.yaml).  The phases'
gates and checks hold, not the JAX package's numbers: those exist for
`chip_smoke.EUROC_DEPTH_RANGE` only.  The room's depth range decides
whether close points (depth < ThDepth x baseline = 35 x 0.110 m) are in
view at all: the walls enter the view at about 2.1 x the near depth.
"""

import argparse
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DEFAULT_RANGES = ((2.0, 8.0), (1.0, 8.0), (1.0, 12.0), (1.2, 5.0),
                  (1.3, 4.5), (1.5, 6.0), (0.8, 8.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranges", nargs="*", default=[
        f"{a},{b}" for a, b in DEFAULT_RANGES])
    ap.add_argument("--mono", action="store_true")
    args = ap.parse_args(argv)
    ranges = [tuple(float(x) for x in r.split(",")) for r in args.ranges]
    import torch
    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false")
    from orb_slam2_tpu_torch import cli as port_cli
    from orb_slam2_tpu_torch import cuda_build, native_build
    from orb_slam2_tpu_torch.core import control
    from orb_slam2_tpu_torch.frontend import fast_cuda
    from orb_slam2_tpu_torch.io import evaluate
    from orb_slam2_tpu_torch.pipeline import mapping, tracking
    from orb_slam2_tpu_torch.solvers import pose_lm_cuda, pose_opt
    print(f"card: {cs.card_line()}", flush=True)
    render = ProcessPoolExecutor(
        min(7, 2 * len(ranges)),
        mp_context=multiprocessing.get_context("spawn"))
    eyes = {r: [render.submit(cs.euroc_eye, side, cs.EUROC_FRAMES, r)
                for side in ("LEFT", "RIGHT")] for r in ranges}
    jobs = [fast_cuda.build, pose_lm_cuda.build,
            lambda: cuda_build.build(control.SOURCE),
            lambda: native_build.build("png_unfilter")]
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda job: job(), jobs))
    counters = (fast_cuda, pose_lm_cuda, pose_opt)
    failed = 0
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        ex_ = (port_cli, mapping, tracking, evaluate, counters, tmp)
        for r, (left, right) in eyes.items():
            seq, raw1 = left.result(), right.result()
            root = os.path.join(tmp, f"euroc_{r[0]}_{r[1]}")
            paths = [("stereo", cs.EUROC_STEREO_SETTINGS,
                      lambda d: cs.write_euroc_dir(d, seq, raw1))]
            if args.mono:
                paths.append(("mono", cs.EUROC_MONO_SETTINGS, None))
            for sensor, settings, write in paths:
                t0 = time.perf_counter()
                try:
                    cs.phase_example(
                        f"EuRoC {sensor}, room depth {r[0]}-{r[1]} m",
                        f"euroc_{sensor}", *ex_, seq, "euroc", sensor, root,
                        settings, None, write=write)
                except cs.PhaseError as e:
                    failed += 1
                    print(f"FAIL: {e}", flush=True)
                print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    render.shutdown()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
