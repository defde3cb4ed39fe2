"""The JAX package on tests/test_e2e.py's loop-closing scenario, open and
closed loop: the reference the port's loop-closing phase is held against.

    JAX_PLATFORMS=cpu python scripts/jax_loop_reference.py small
    JAX_PLATFORMS=cpu python scripts/jax_loop_reference.py default

`small` is test_e2e's small configuration (320x240, 500 features),
`default` the default SLAMConfig (640x480, 1000 features).  The sequence is
test_loop_closure_fires_and_helps's: loop trajectory, 140 frames, 300
points, seed 1, 1.3 revolutions.  Prints, for the open and the closed run,
the scale-aligned ATE, the tracked frames, the keyframe the loop closed at
(-100: never) and the keyframe count.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam2_tpu import config  # noqa: E402
from orb_slam2_tpu.io import evaluate, synthetic  # noqa: E402
from orb_slam2_tpu.pipeline.system import SLAM  # noqa: E402


def small_cfg():
    cam = config.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                              width=320, height=240, fps=30.0, bf=0.0,
                              th_depth=35.0)
    return config.SLAMConfig(
        camera=cam, orb=config.ORBConfig(n_features=500, max_keypoints=512),
        cap=config.Capacity(max_keyframes=96, max_points=6144,
                            max_obs_per_kf=512, max_frames=512,
                            local_ba_points=2048))


def main(which: str):
    cfg = config.SLAMConfig() if which == "default" else small_cfg()
    seq = synthetic.generate(cfg.camera, n_frames=140, n_points=300,
                             trajectory="loop", seed=1, loop_revolutions=1.3)
    for loop in (False, True):
        t0 = time.time()
        slam = SLAM(cfg, enable_loop_closing=loop)
        for f in range(len(seq.images)):
            slam.track_mono(seq.images[f], seq.timestamps[f])
        slam.flush()
        est = slam.poses_twc()
        ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
        ate = evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=True)
        print(f"{which} {'closed' if loop else 'open'}: ATE {ate} m, "
              f"tracked {len(ie)}/{len(seq.images)}, loop at keyframe "
              f"{slam.last_loop_kf}, keyframes {int(slam.state.n_kf)}, "
              f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "small")
