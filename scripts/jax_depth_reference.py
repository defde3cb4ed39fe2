"""The JAX package on the bench's stereo and RGB-D runs: the reference the
port's `chip_smoke.py` phases 9 and 10 are held against.

    JAX_PLATFORMS=cpu python scripts/jax_depth_reference.py [stereo] [rgbd]

The configuration and sequence are bench.py `_run_stereo`'s: the default
SLAMConfig with bf = 40 (640x480, 1000 features), 60 frames of the xyz
trajectory, 500 points, seed 0, the right eye rendered from `right_poses`;
RGB-D takes the same configuration and the renderer's depth maps.  Prints,
for each sensor, the frames tracked, the metric ATE (no scale alignment),
the keyframes (and the frames they were made at) and the map points.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam2_tpu import config  # noqa: E402
from orb_slam2_tpu.io import evaluate, synthetic  # noqa: E402
from orb_slam2_tpu.pipeline.system import SLAM  # noqa: E402

N_FRAMES = 60


def run(name: str) -> dict:
    sensor = {"stereo": config.STEREO, "rgbd": config.RGBD}[name]
    cfg = config.SLAMConfig(sensor=sensor,
                            camera=config.CameraConfig(bf=40.0))
    seq = synthetic.generate(cfg.camera, n_frames=N_FRAMES, n_points=500,
                             trajectory="xyz", seed=0)
    right = synthetic.generate(
        cfg.camera, n_frames=N_FRAMES, n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(seq.poses_twc,
                                             cfg.camera.baseline)).images
    slam = SLAM(cfg)
    t0 = time.perf_counter()
    for f in range(N_FRAMES):
        if sensor == config.STEREO:
            slam.track_stereo(seq.images[f], right[f], seq.timestamps[f])
        else:
            slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])
    slam.flush()
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    kv = np.asarray(slam.state.kf_valid)
    return dict(sensor=name, tracked=len(ie), frames=N_FRAMES,
                ate_m=float(evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                              align_scale=False)),
                keyframes=int(slam.state.n_kf),
                keyframe_frames=np.asarray(slam.state.kf_frame_id)[kv]
                .tolist(),
                map_points=int(slam.state.n_mp),
                cpu_wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    for which in sys.argv[1:] or ["stereo", "rgbd"]:
        print(run(which), flush=True)
