"""The JAX package on the session scenarios of the port's `chip_smoke.py`
phases 11-14 and 21-24, on the CPU: the reference their thresholds are
held against.

    JAX_PLATFORMS=cpu python scripts/jax_session_reference.py \
        [mono_loc] [kitti] [tum] [tum_mono] [kitti_mono] [euroc_stereo] \
        [euroc_mono] [vocab_mono] [vocab_reloc] [vocab_loop] \
        [--kitti-trajectory xyz|forward] [--kitti-frames N]

(no scenario named: the first three)

Each scenario runs on the very images the port's phase sees: the sequences
are rendered by the port's numpy renderer and written to disk by
`chip_smoke.py`'s own writers (its PNG encoder, directory layouts and
settings files), then read back by the JAX package's loaders and CLI.  So
this script imports the port's renderer and `chip_smoke.py` beside the JAX
package.

- mono_loc (phase 11): the bench mono sequence (default SLAMConfig, 120
  frames, 500 points, xyz, seed 0) mapped over frames 0-45, the map saved,
  loaded into a fresh session in localisation mode, frames 10-30 tracked;
- kitti (phases 12-13): the room at the KITTI 00-02 camera in the KITTI
  odometry layout, `tpu-slam run --dataset kitti --sensor stereo` with the
  KITTI settings file (2048 keyframes, 131,072 points), then the saved map
  loaded into a fresh session in localisation mode over part of it;
- tum (phase 14): the bench's stereo sequence (bf 40, 60 frames) as a TUM
  RGB-D directory, `tpu-slam run --dataset tum --sensor rgbd`, and the
  keyframe trajectory file;
- tum_mono (phase 21): the bench mono scene through TUM1's fr1 lens as a
  TUM directory, `tpu-slam run --dataset tum --sensor mono` with the lens
  in the settings;
- kitti_mono (phase 22): the kitti scenario's directory, `--sensor mono`
  with the same settings;
- euroc_stereo (phase 23): a room at the EuRoC rig written as raw
  distorted cam0/cam1 images, `tpu-slam run --dataset euroc --sensor
  stereo` with the reference's EuRoC.yaml (rectified on the host);
- euroc_mono (phase 24): that directory's cam0 under the reference's
  monocular EuRoC.yaml (cam0's own lens).  The JAX CLI builds the
  rectification maps for every EuRoC run given settings, and those
  settings have no LEFT/RIGHT blocks, so this scenario feeds the JAX
  package's loader and reader to its session as the CLI would;
- vocab_mono, vocab_reloc, vocab_loop (phases 26-27): place recognition
  at the JAX package's at-scale width.  `chip_smoke.wide_vocabulary`'s
  k = 10, L = 6 tree is written in DBoW2's text format by the port's
  writer and read by the JAX package's `load_orbvoc_text` with
  truncate_depth = 5 (99,030 words), saved as the npz `SLAM(vocab_path=)`
  reads, and the sessions run with `VocabConfig(depth=5)` (BoW width
  10^5): the bench mono sequence (phase 5's, 120 frames); phase 6's
  relocalisation scenario (did it recover); phase 7's loop at
  test_e2e's small configuration, open and closed.

Prints one dict per scenario: frames tracked, ATE, keyframes, map points,
CPU wall time.
"""

import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orb_slam2_tpu import cli, config  # noqa: E402
from orb_slam2_tpu.io import datasets, evaluate  # noqa: E402
from orb_slam2_tpu.io.settings import load_settings  # noqa: E402
from orb_slam2_tpu.pipeline import system  # noqa: E402
from orb_slam2_tpu_torch import config as tconfig  # noqa: E402
from orb_slam2_tpu_torch.io import synthetic as tsynthetic  # noqa: E402


def _sessions():
    """Record every SLAM session the JAX CLI makes."""
    made = []
    init = system.SLAM.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    system.SLAM.__init__ = recording
    return made


def _ate(slam, seq, align_scale):
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    return float(evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                   align_scale=align_scale)), len(ie)


def mono_loc(tmp):
    cfg = config.SLAMConfig()
    seq = tsynthetic.generate(tconfig.SLAMConfig().camera,
                              n_frames=chip_smoke.N_FRAMES, n_points=500,
                              trajectory="xyz", seed=0)
    t0 = time.perf_counter()
    slam = system.SLAM(cfg)
    for f in range(chip_smoke.LOC_MAP_FRAMES):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    path = os.path.join(tmp, "mono_map.npz")
    slam.save_map(path)
    n_kf, n_mp = int(slam.state.n_kf), int(slam.state.n_mp)
    loc = system.SLAM(cfg)
    loc.load_map(path)
    loc.activate_localization_mode()
    a, b = chip_smoke.LOC_FRAMES
    for f in range(a, b):
        loc.track_mono(seq.images[f], seq.timestamps[f])
    loc.flush()
    ate, n = _ate(loc, seq, True)
    return dict(scenario="mono_loc", map_keyframes=n_kf, map_points=n_mp,
                status=loc.status, keyframes_after=int(loc.state.n_kf),
                points_after=int(loc.state.n_mp), tracked=n,
                frames=b - a, ate_m=ate, cpu_wall_s=time.perf_counter() - t0)


def kitti(tmp, trajectory, n_frames):
    cam = tconfig.kitti_config().camera
    seq, right = chip_smoke.kitti_sequence(tsynthetic, cam, n_frames,
                                           trajectory)
    root = os.path.join(tmp, "kitti_00")
    chip_smoke.write_kitti_dir(root, seq, right)
    yaml = os.path.join(tmp, "kitti.yaml")
    with open(yaml, "w") as f:
        f.write(chip_smoke.KITTI_SETTINGS)
    out = os.path.join(tmp, "kitti_traj.txt")
    made = _sessions()
    t0 = time.perf_counter()
    cli.main(["run", "--dataset", "kitti", "--sensor", "stereo", "--path",
              root, "--settings", yaml, "--output", out])
    wall = time.perf_counter() - t0
    slam = made[-1]
    est = chip_smoke.read_kitti_positions(out)
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    ate = float(evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                  align_scale=False))
    kv = np.asarray(slam.state.kf_valid)
    res = dict(scenario="kitti", trajectory=trajectory, frames=n_frames,
               tracked=len(ie), ate_m=ate, keyframes=int(slam.state.n_kf),
               keyframe_frames=np.asarray(slam.state.kf_frame_id)[kv]
               .tolist(), map_points=int(slam.state.n_mp), cpu_wall_s=wall)
    # phase 13: localisation on the saved map
    path = os.path.join(tmp, "kitti_map.npz")
    slam.save_map(path)
    cfg = load_settings(yaml, config.STEREO)
    loc = system.SLAM(cfg)
    loc.load_map(path)
    loc.activate_localization_mode()
    a, b = chip_smoke.KITTI_LOC_FRAMES
    items = datasets.load_kitti_stereo(root)[a:b]
    for left, rgt, t in datasets.SequenceReader(items, "stereo"):
        loc.track_stereo(left, rgt, t)
    loc.flush()
    ate_l, n_l = _ate(loc, seq, False)
    res.update(loc_status=loc.status, loc_tracked=n_l, loc_frames=b - a,
               loc_ate_m=ate_l, loc_keyframes=int(loc.state.n_kf))
    return res


def tum(tmp):
    cfg = tconfig.SLAMConfig(sensor=tconfig.RGBD,
                             camera=tconfig.CameraConfig(bf=40.0))
    seq = tsynthetic.generate(cfg.camera, n_frames=chip_smoke.STEREO_FRAMES,
                              n_points=500, trajectory="xyz", seed=0)
    root = os.path.join(tmp, "tum_rgbd")
    chip_smoke.write_tum_rgbd_dir(root, seq, cfg.camera.depth_map_factor)
    yaml = os.path.join(tmp, "tum.yaml")
    with open(yaml, "w") as f:
        f.write(chip_smoke.tum_settings(cfg.camera))
    out = os.path.join(tmp, "tum_traj.txt")
    made = _sessions()
    t0 = time.perf_counter()
    cli.main(["run", "--dataset", "tum", "--sensor", "rgbd", "--path", root,
              "--settings", yaml, "--output", out])
    wall = time.perf_counter() - t0
    slam = made[-1]
    ts, est = chip_smoke.read_tum_positions(out)
    ie, ig = evaluate.match_timestamps(ts, seq.timestamps)
    kf_path = os.path.join(tmp, "tum_kf.txt")
    slam.save_keyframe_trajectory_tum(kf_path)
    return dict(scenario="tum", frames=len(seq.images), tracked=len(ie),
                ate_m=float(evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                              align_scale=False)),
                keyframes=int(slam.state.n_kf),
                keyframe_lines=len(np.loadtxt(kf_path, ndmin=2)),
                map_points=int(slam.state.n_mp), cpu_wall_s=wall)


def _vocab_npz(tmp):
    """The wide tree's 10^5 truncation as JAX reads it, saved as npz."""
    out = os.path.join(tmp, "vocab_1e5.npz")
    if not os.path.exists(out):
        from orb_slam2_tpu.place import vocab as jvocab
        from orb_slam2_tpu_torch.place import vocab as tvocab
        txt = os.path.join(tmp, "ORBvoc_wide.txt")
        tvocab.save_orbvoc_text(chip_smoke.wide_vocabulary(
            tvocab, tvocab.Vocabulary.load(os.path.join(
                ROOT, "orb_slam2_tpu_torch", "data", "vocab_default.npz"))),
            txt)
        v = jvocab.load_orbvoc_text(txt, levels_up=2,
                                    truncate_depth=chip_smoke.TRUNC_DEPTH)
        assert v.n_words <= 10 ** chip_smoke.TRUNC_DEPTH, v.n_words
        v.save(out)
    return out


def _at_1e5(cfg):
    return cfg.replace(vocab=config.VocabConfig(
        depth=chip_smoke.TRUNC_DEPTH))


def vocab_mono(tmp):
    """The bench mono sequence at 10^5 words, and with the default
    vocabulary (10^4) beside it: BoW feeds only the loop and
    relocalisation candidates, so where neither fires the two runs are
    the same."""
    seq = tsynthetic.generate(tconfig.SLAMConfig().camera,
                              n_frames=chip_smoke.N_FRAMES, n_points=500,
                              trajectory="xyz", seed=0)
    out = []
    for name, cfg, path in (
            ("vocab_mono", _at_1e5(config.SLAMConfig()), _vocab_npz(tmp)),
            ("vocab_mono_1e4", config.SLAMConfig(), None)):
        slam = system.SLAM(cfg, vocab_path=path)
        t0 = time.perf_counter()
        for f in range(len(seq.images)):
            slam.track_mono(seq.images[f], seq.timestamps[f])
        slam.flush()
        out.append(dict(_scored(name, slam, seq, slam.timestamps(),
                                slam.poses_twc(), True,
                                time.perf_counter() - t0),
                        loop_kf=slam.last_loop_kf,
                        poses_sha=_digest(slam.poses_twc())))
    return out


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def vocab_reloc(tmp):
    """Phase 6's scenario (`chip_smoke.phase_reloc`) at 10^5 words."""
    cfg = _at_1e5(config.SLAMConfig())
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                   max_frames_hint=6))
    seq = tsynthetic.generate(tconfig.SLAMConfig().camera, n_frames=60,
                              n_points=300, trajectory="xyz", seed=0)
    t0 = time.perf_counter()
    slam = system.SLAM(cfg, vocab_path=_vocab_npz(tmp))
    for f in range(45):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    kfs, status45 = int(slam.state.n_kf), slam.status
    blank = np.zeros_like(seq.images[0])
    for k in range(4):
        slam.track_mono(blank, seq.timestamps[45] + 0.001 * (k + 1))
    slam.flush()
    status_blind = slam.status
    for f in range(38, 55):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return dict(scenario="vocab_reloc", status_at_45=status45,
                keyframes_at_45=kfs, status_blind=status_blind,
                status_end=slam.status, recovered=slam.status == 2,
                keyframes_end=int(slam.state.n_kf),
                cpu_wall_s=time.perf_counter() - t0)


def vocab_loop(tmp):
    """Phase 7's loop (`chip_smoke.phase_loop`) at 10^5 words."""
    cfg = _at_1e5(chip_smoke.e2e_small_cfg(config))
    seq = tsynthetic.generate(cfg.camera, n_frames=chip_smoke.LOOP_FRAMES,
                              n_points=300, trajectory="loop", seed=1,
                              loop_revolutions=1.3)
    out = dict(scenario="vocab_loop")
    for name, loop in (("open", False), ("closed", True)):
        t0 = time.perf_counter()
        slam = system.SLAM(cfg, vocab_path=_vocab_npz(tmp),
                           enable_loop_closing=loop)
        for f in range(len(seq.images)):
            slam.track_mono(seq.images[f], seq.timestamps[f])
        slam.flush()
        ate, n = _ate(slam, seq, True)
        out.update({f"{name}_ate_m": ate, f"{name}_tracked": n,
                    f"{name}_loop_kf": slam.last_loop_kf,
                    f"{name}_keyframes": int(slam.state.n_kf),
                    f"{name}_cpu_wall_s": time.perf_counter() - t0})
    return out


def _scored(name, slam, seq, ts, est, mono, wall):
    ie, ig = evaluate.match_timestamps(ts, seq.timestamps)
    kv = np.asarray(slam.state.kf_valid)
    return dict(scenario=name, frames=len(seq.timestamps), tracked=len(ie),
                ate_m=float(evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                                              align_scale=mono)),
                keyframes=int(slam.state.n_kf),
                keyframe_frames=np.asarray(slam.state.kf_frame_id)[kv]
                .tolist(), map_points=int(slam.state.n_mp), cpu_wall_s=wall)


def _cli(name, tmp, seq, dataset, sensor, root, settings):
    """`tpu-slam run` on `root` with the settings text `settings`; the
    trajectory file scored against `seq`."""
    yaml = os.path.join(tmp, f"{name}.yaml")
    with open(yaml, "w") as f:
        f.write(settings)
    out = os.path.join(tmp, f"{name}_traj.txt")
    made = _sessions()
    t0 = time.perf_counter()
    cli.main(["run", "--dataset", dataset, "--sensor", sensor, "--path",
              root, "--settings", yaml, "--output", out])
    wall = time.perf_counter() - t0
    slam = made[-1]
    if dataset == "kitti":
        ts, est = slam.timestamps(), chip_smoke.read_kitti_positions(out)
    else:
        ts, est = chip_smoke.read_tum_positions(out)
    return _scored(name, slam, seq, ts, est, sensor == "mono", wall)


def tum_mono(tmp):
    cam = tconfig.tum1_config().camera
    seq = chip_smoke.lens_sequence(cam)
    root = os.path.join(tmp, "tum_fr1")
    chip_smoke.write_tum_mono_dir(root, seq)
    return _cli("tum_mono", tmp, seq, "tum", "mono", root,
                chip_smoke.tum_settings(cam))


def kitti_mono(tmp, trajectory, n_frames):
    seq, right = chip_smoke.kitti_sequence(
        tsynthetic, tconfig.kitti_config().camera, n_frames, trajectory)
    root = os.path.join(tmp, "kitti_00")
    chip_smoke.write_kitti_dir(root, seq, right)
    res = _cli("kitti_mono", tmp, seq, "kitti", "mono", root,
               chip_smoke.KITTI_SETTINGS)
    return dict(res, trajectory=trajectory)


def _euroc_dir(tmp):
    seq = chip_smoke.euroc_eye("LEFT")
    root = os.path.join(tmp, "euroc_mav")
    if not os.path.isdir(root):
        chip_smoke.write_euroc_dir(root, seq, chip_smoke.euroc_eye("RIGHT"))
    return seq, root


def euroc_stereo(tmp):
    seq, root = _euroc_dir(tmp)
    return _cli("euroc_stereo", tmp, seq, "euroc", "stereo", root,
                chip_smoke.EUROC_STEREO_SETTINGS)


def euroc_mono(tmp):
    seq, root = _euroc_dir(tmp)
    yaml = os.path.join(tmp, "euroc_mono.yaml")
    with open(yaml, "w") as f:
        f.write(chip_smoke.EUROC_MONO_SETTINGS)
    slam = system.SLAM(load_settings(yaml, config.MONOCULAR))
    t0 = time.perf_counter()
    items = datasets.load_euroc_stereo(root)
    for img, t in datasets.SequenceReader(items, "mono"):
        slam.track_mono(img, t)
    slam.flush()
    wall = time.perf_counter() - t0
    return _scored("euroc_mono", slam, seq, slam.timestamps(),
                   slam.poses_twc()[:, 4:], True, wall)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", default=["mono_loc", "kitti", "tum"])
    ap.add_argument("--kitti-trajectory", default=chip_smoke.KITTI_TRAJECTORY,
                    choices=["xyz", "forward"])
    ap.add_argument("--kitti-frames", type=int,
                    default=chip_smoke.KITTI_FRAMES)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        for which in args.which:
            if which in ("kitti", "kitti_mono"):
                res = {"kitti": kitti, "kitti_mono": kitti_mono}[which](
                    tmp, args.kitti_trajectory, args.kitti_frames)
            else:
                res = {"mono_loc": mono_loc, "tum": tum,
                       "tum_mono": tum_mono, "euroc_stereo": euroc_stereo,
                       "euroc_mono": euroc_mono, "vocab_mono": vocab_mono,
                       "vocab_reloc": vocab_reloc,
                       "vocab_loop": vocab_loop}[which](tmp)
            print(res, flush=True)
