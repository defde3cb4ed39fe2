"""Command-line interface of the port (counterpart of orb_slam2_tpu/cli.py):
the reference's six example binaries (mono_tum, mono_kitti, mono_euroc,
stereo_kitti, stereo_euroc, rgbd_tum — Examples/, CMakeLists.txt:85-112)
and the synthetic sequence behind one entry point:

    tpu-slam-torch run --dataset tum --sensor mono --path <seq> [--settings x.yaml]
    tpu-slam-torch run --dataset kitti --sensor stereo --path <seq> --settings KITTI00-02.yaml
    tpu-slam-torch run --dataset euroc --sensor stereo --path <seq> --settings EuRoC.yaml
    tpu-slam-torch run --dataset synthetic --sensor mono --frames 120
    tpu-slam-torch view --map map.npz --traj CameraTrajectory.txt --out map.png
    tpu-slam-torch bench [--device cpu]

`run` and `bench` run on the CUDA card unless `--device` names another
device; `bench` is orb_slam2_tpu_torch/bench.py (one JSON line).  The
trajectory goes to `--output` (default CameraTrajectory.txt) in TUM format,
or in KITTI format for `--dataset kitti`.  EuRoC stereo rectifies both
raw images on the host by the settings' LEFT/RIGHT blocks; EuRoC mono
reads cam0 raw under the settings' lens.  `view` renders a saved map (the
npz of `SLAM.save_map`, either package's) with an optional TUM trajectory,
or the trajectory alone, to a PNG on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _build_cfg(args):
    from orb_slam2_tpu_torch import config as cfg_mod
    sensor = dict(mono=cfg_mod.MONOCULAR, stereo=cfg_mod.STEREO,
                  rgbd=cfg_mod.RGBD)[args.sensor]
    if args.settings:
        from orb_slam2_tpu_torch.io.settings import load_settings
        return load_settings(args.settings, sensor)
    if args.dataset == "kitti":
        return cfg_mod.kitti_config()
    if args.dataset == "euroc":
        return cfg_mod.euroc_config()
    if args.dataset == "tum":
        return cfg_mod.tum1_config(sensor)
    cam = cfg_mod.CameraConfig(bf=40.0 if sensor != cfg_mod.MONOCULAR else 0.0)
    return cfg_mod.SLAMConfig(sensor=sensor, camera=cam)


def _median_ms(timings) -> float:
    return float(np.median(timings[10:]) * 1000) if len(timings) > 10 \
        else float("nan")


def _track(slam, sensor: str, data):
    if sensor == "mono":
        slam.track_mono(*data)
    elif sensor == "rgbd":
        slam.track_rgbd(*data)
    else:
        slam.track_stereo(*data)


def cmd_run(args):
    from orb_slam2_tpu_torch.pipeline.system import SLAM

    cfg = _build_cfg(args)
    slam = SLAM(cfg, device=args.device)
    if args.dataset == "synthetic":
        from orb_slam2_tpu_torch.io import evaluate, synthetic
        seq = synthetic.generate(cfg.camera, n_frames=args.frames,
                                 n_points=args.points,
                                 trajectory=args.trajectory, seed=args.seed)
        # the second image of a frame: the depth map or the right eye
        second = None
        if args.sensor == "rgbd":
            second = seq.depths
        elif args.sensor == "stereo":
            second = synthetic.stereo_right_images(seq, cfg.camera)
        t0 = time.time()
        for f in range(args.frames):
            _track(slam, args.sensor, (seq.images[f],) +
                   (() if second is None else (second[f],)) +
                   (seq.timestamps[f],))
        wall = time.time() - t0
        est = slam.poses_twc()
        ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
        ate = (evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                 align_scale=args.sensor == "mono")
               if len(ie) >= 10 else float("nan"))
        print(f"tracked {len(ie)}/{args.frames}  ATE RMSE {ate*100:.2f} cm  "
              f"median {_median_ms(slam.timings):.1f} ms/frame  "
              f"wall {wall:.1f}s")
    else:
        from orb_slam2_tpu_torch.io import datasets
        if args.dataset == "tum" and args.sensor == "mono":
            items = datasets.load_tum_mono(args.path)
        elif args.dataset == "tum":
            items = datasets.load_tum_rgbd(args.path, args.associations)
        elif args.dataset == "kitti":
            items = datasets.load_kitti_stereo(args.path)
        else:
            items = datasets.load_euroc_stereo(args.path)
        # the stereo pair is rectified on the host by the settings'
        # LEFT/RIGHT blocks (stereo_euroc.cc); mono_euroc reads cam0 raw
        # under its own lens model, whose settings have no such blocks
        rectify = None
        if args.dataset == "euroc" and args.sensor == "stereo" and \
                args.settings:
            rectify = datasets.euroc_rectify_maps(args.settings)
        reader = datasets.SequenceReader(
            items, args.sensor, depth_factor=cfg.camera.depth_map_factor,
            rectify=rectify)
        print(f"{len(reader)} frames")
        read_s, it = [], iter(reader)
        for i in range(len(reader)):
            t0 = time.perf_counter()
            frame_data = next(it)
            read_s.append(time.perf_counter() - t0)
            _track(slam, args.sensor, frame_data)
            if args.max_frames and i + 1 >= args.max_frames:
                break
        print(f"median track time {_median_ms(slam.timings):.1f} ms/frame, "
              f"image read {np.median(read_s) * 1000:.1f} ms/frame")

    out = args.output or "CameraTrajectory.txt"
    if args.dataset == "kitti":
        slam.save_trajectory_kitti(out)
    else:
        slam.save_trajectory_tum(out)
    print("trajectory saved to", out)
    return slam


def cmd_view(args):
    """Render a saved map checkpoint and/or a TUM trajectory to a PNG (the
    headless equivalent of the reference Pangolin viewer, Viewer.cc /
    MapDrawer.cc); returns the path written, None without an input."""
    from orb_slam2_tpu_torch.viz.viewer import render_map, render_trajectory
    traj = None
    if args.traj:
        rows = np.loadtxt(args.traj, ndmin=2)
        # TUM format: t tx ty tz qx qy qz qw -> [F, 7] wxyz + t
        traj = np.concatenate([rows[:, [7, 4, 5, 6]], rows[:, 1:4]], axis=1)
    if args.map:
        from orb_slam2_tpu_torch.map.checkpoint import load_map
        state = load_map(args.map, device="cpu")
        out = render_map(state, args.out, traj=traj,
                         title=os.path.basename(args.map))
    elif traj is not None:
        out = render_trajectory(traj, args.out)
    else:
        print("need --map and/or --traj", file=sys.stderr)
        return None
    print("wrote", out)
    return out


def cmd_bench(args):
    """The port's benchmark run (orb_slam2_tpu_torch/bench.py, the
    counterpart of the root bench.py that JAX cli.py:138 runs); returns
    its JSON object.  A failure raises."""
    from orb_slam2_tpu_torch import bench
    return bench.main(([] if args.device is None else
                       ["--device", args.device]) +
                      (["--small"] if args.small else []))


def main(argv=None):
    """Parse `argv` and run the command; returns the `run` command's
    session, the path `view` wrote or `bench`'s JSON object."""
    ap = argparse.ArgumentParser(prog="tpu-slam-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run SLAM on a sequence")
    run.add_argument("--dataset", default="synthetic",
                     choices=["synthetic", "tum", "kitti", "euroc"])
    run.add_argument("--sensor", default="mono",
                     choices=["mono", "stereo", "rgbd"])
    run.add_argument("--path", help="dataset sequence directory")
    run.add_argument("--settings", help="reference-format YAML settings")
    run.add_argument("--associations", help="TUM RGB-D associations file")
    run.add_argument("--output", help="trajectory output path")
    run.add_argument("--frames", type=int, default=120)
    run.add_argument("--points", type=int, default=500)
    run.add_argument("--trajectory", default="xyz",
                     choices=["xyz", "forward"])
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--max-frames", type=int, default=0)
    run.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")
    run.set_defaults(fn=cmd_run)
    view = sub.add_parser("view", help="render a map/trajectory image")
    view.add_argument("--map", help="map checkpoint (npz from save_map)")
    view.add_argument("--traj", help="TUM-format trajectory file")
    view.add_argument("--out", default="map.png")
    view.set_defaults(fn=cmd_view)
    bench = sub.add_parser("bench", help="the benchmark run (one JSON line)")
    bench.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
    bench.add_argument("--small", action="store_true",
                       help="tests/test_e2e.py's 320x240 mono configuration")
    bench.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
