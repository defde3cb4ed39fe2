#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and nvcc.  Phases,
each of which fails the run when it fails:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: compile csrc/fast_nms.cu, csrc/pose_lm.cu, csrc/bow_score.cu
     and csrc/graph_cond.cu (the CUDA graph IF nodes of core/control.py) with
     nvcc (sm_90a), and the pose LM at each cluster size 1, 2, 4, 8, all at
     once (one nvcc each), printing ptxas's register and shared-memory
     counts;
  3. FAST kernel: the all-level FAST-9+NMS kernel against its plain
     PyTorch version on the card, bit-exact, on the level atlas of the main
     path (8 levels of 640x480), of the small configuration (8 levels of
     320x240), of two seeded 640x480 images and on the two-image atlas that
     the stereo path builds from a rendered stereo pair; CUDA-event and
     torch.profiler timings; one frame, and that stereo pair, through the
     extractor on the card and on the CPU;
  4. pose-LM kernel: the one-launch pose LM against `pose_optimize_plain`
     on the card at N = 1024 mono, N = 1024 with a third of the rows
     stereo, N = 1024 with every row stereo, N = 64, and a batch of 4
     problems (seeded, ~10% outliers): pose within 1e-4, inlier masks agree
     on >= 99% of points, inlier counts within 2, two launches
     bit-identical; call, device and plain times; its bound; then the
     kernel at each cluster size on 8 seeded N = 1024 mono problems: device
     and call times, LM iterations; after phase 9, the same checks on a
     problem recorded from a stereo frame of that run;
  5. main path: monocular SLAM at the default SLAMConfig (640x480, 1000
     features, 32768 map points, 512 keyframes) with the default vocabulary
     on, on the bench sequence (120 frames, 500 points, xyz trajectory,
     seed 0), through `SLAM.track_mono`; checks tracking rate, scale-aligned
     ATE, that the state lives on the card, BoW on every keyframe, one
     graph launch a frame, at least two pose-LM kernel launches a tracked
     frame and every frame's pyramid through one FAST launch (phase 20
     holds the launches to the eager step's `pose_optimize` calls);
  6. relocalisation (tests/test_e2e.py test_relocalization_recovers at the
     default config): track, blind the camera for 4 frames, revisit; must
     recover without a reset, through the pose-LM kernel;
  7. loop closing (test_e2e.py test_loop_closure_fires_and_helps, on its
     small configuration: at the default one the JAX package itself tracks
     54 of the 140 frames and never closes this loop): 1.3 revolutions,
     open and closed; the loop must fire and the closed ATE be <= 1.05 x
     the open one; run again at the end of the process, after every other
     phase, its per-frame records and exported poses bit-identical to the
     first run's;
  8. determinism: two fresh 30-frame runs give bit-identical poses, mono
     and stereo;
  9. stereo main path: the bench's stereo configuration (bench.py
     `_run_stereo`: the default SLAMConfig with sensor STEREO and bf = 40,
     nothing cut) on its 60-frame sequence (500 points, xyz, seed 0) with
     the right eye rendered from `right_poses`, through `SLAM.track_stereo`;
     >= 90% tracked under the metric-ATE gate of test_stereo_e2e (0.06 m),
     the state on the card, BoW on every keyframe, one FAST launch over 16
     planes a frame, every pose LM through its kernel, depth points made by
     a keyframe after the first;
 10. RGB-D main path: the same with sensor RGBD, fed the sequence's depth
     maps, through `SLAM.track_rgbd`, under test_rgbd_e2e's 0.02 m; one
     FAST launch over 8 planes a frame;
 11. mono localisation: the bench mono sequence mapped over frames 0-45,
     `save_map`, a fresh session `load_map` + `activate_localization_mode`
     over frames 10-30: status OK, the map unchanged, scale-aligned ATE
     <= 0.05 m;
 12. the KITTI preset through the CLI: a synthetic sequence (the room at
     the KITTI 00-02 camera, 1241x376, forward motion, 40 frames) written
     as a KITTI odometry directory (8-bit PNGs, times.txt) with a KITTI
     00-02 settings file (2048 keyframes, 131,072 points), `cli.main(["run",
     "--dataset", "kitti", ...])`, the KITTI-format file read back: >= 90%
     tracked, metric ATE <= 0.06 m and within 0.01 m of the JAX package's
     on the same directory, keyframes within 2 of its; prints the frames
     need_close fired on, the close depth points made, frame ms, launches
     a frame and peak memory;
 13. stereo localisation at the KITTI preset: phase 12's map saved, loaded
     in a fresh session in localisation mode over frames 5-24: status OK,
     the map unchanged, VO points used as pose-LM inliers > 0;
 14. the bench's stereo sequence as a TUM RGB-D directory (8-bit RGB PNGs,
     16-bit depth PNGs at factor 5000) through the CLI: >= 90% tracked,
     metric ATE <= 0.02 m; `save_keyframe_trajectory_tum` writes one line
     per live keyframe;
 15. frame batching: the bench mono sequence's first 60 frames with
     frame_batch = 4 and 1 give bit-identical trajectory logs up to the
     first host reaction that changed the state (named if there is one);
 16. the per-level extractor at full width, on frame 0 of the bench mono
     sequence (640x480, 1000 features) and of the KITTI 00-02 preset's
     left images (1241x376, 2000): every level's single-image FAST
     (`fast_nms_raw`) bit-exact with its plain version on the card, the
     whole Features equal to the extractor with the plain FAST on the card,
     exactly n_levels launches an image; per-level against atlas extraction
     ms, the single-plane launches' summed device time against their bytes
     bound, and the share of atlas keypoints the per-level extractor also
     finds (same octave, within 1 px);
 17. viewer, AR and `view` on the card's session: `ARSession.step` over
     the bench mono sequence's first AR_FRAMES frames, then
     `draw_current_frame` (a w x (h + 26) PNG read back: the tracked colour
     on every tracked keypoint's square, the status bar's text pixel for
     pixel the string of the session's status, keyframes, points and
     matches), `render_map` of the map with its trajectory, `cli.main(
     ["view", ...])` on the saved map and TUM trajectory, and `render_ar`
     (with a plane found: the cube's colour at its in-frame edges); render
     ms (host).
 18. S RGB-D sequences stepped together (`distributed/dp.py`) at the RGB-D
     cell's configuration, on the bench renderer's 48-frame xyz sequences
     of seeds 0..S-1, S = 1, 2, 4, 8: FAST bit-exact on the 32- and
     64-plane atlases of frame 0; every S through the captured program
     (`DPProgram`: one graph replay a step, no synchronisation after
     `init` under `set_sync_debug_mode("error")`) and through the eager
     program on the same inputs (timed at S = 1, 2, 4, and at every S
     profiled by phase: device ms and kernels a step of extraction,
     tracking, insertion, stage and the rest, `dp_profile.py`):
     bit-identical states and HUDs and equal device launch counts; each
     run one FAST launch a step over 8·S planes, every pose LM through its
     kernel, the S sequences' tracking batched (one local-map solve a
     step, one motion-model and one reference-keyframe solve in the steps
     where some sequence took them: 2 a step plus the steps that also took
     the reference keyframe, whatever S is), every sequence >= 90%
     tracked with metric ATE <= 0.02 m; the keyframe insertion and each
     stage group (triangulate, fuse, BA chunk, cull) one batched call in
     a step at most, whatever S (device-counted), with the insertion and
     stage kernels a step by S; the S = 4 run's sequences against their
     own S = 1 runs, every state field and HUD bit-identical; one
     batched track call at S = 4 on the inputs recorded at a step, and on
     a mixed batch made from them (no velocity, a failing motion model),
     against 4 single calls, bit for bit; step ms (CUDA events, median
     and p90), window wall
     ms, host ms a step call, total frames/s and its ratio to S = 1,
     device ms a step and idle share (profiled over the same steps), FAST
     and pose-LM device ms a launch under replay, peak memory and capture
     seconds at S = 8; `build_sharded_step` on a 1-rank gloo group issues
     no collective in two profiled steps;
 19. the sharded solvers: `distributed/launch.py` spawns 2 gloo ranks on
     the one card (CUDA tensors, joined by `init_multihost` from SLAM_*),
     observation-sharded BA on 64 cameras x 4,096 points, landmark-sharded
     BA on phase 18's sequence-0 map (saved with `map/checkpoint.py`,
     loaded by each rank) and the pose graph of a 48-node ring, each run
     twice: bit-equal on repeat and across ranks, within
     tests/test_distributed.py's tolerances of the single-rank solve here;
     sharded and single-rank ms, all-reduces and their ms.
 20. one program: the mono cell (120 frames), the stereo and RGB-D cells
     (60 frames) and the mono cell with frame_batch = 4, each twice on the
     same inputs: through the session's captured program (its default on
     the card) and through the eager step (`SLAM(..., capture=False)`).
     Trajectories and states bit-identical (else the first differing field
     is named and the ATEs agree within 1e-6 m); no synchronisation under
     `torch.cuda.set_sync_debug_mode("error")` across the tracked frames
     outside the host reactions; one graph launch a frame (a batch); the
     kernels' device launch counts equal to the eager run's (one FAST
     launch a frame, two pose LMs or more a tracked frame), and in the
     eager run one pose LM launch for each `pose_optimize` call; frame ms
     p50/p90/max, device ms a frame and idle share (torch.profiler over a
     window) and peak memory of both.
 21. mono_tum with TUM1's fr1 lens (k1 0.262383, k2 -0.953104, k3
     1.163314): the bench mono scene (500 points, xyz, seed 0, 120 frames)
     rendered by the pinhole camera, each pixel of the written image
     sampled at its undistorted position (`core/camera.undistort_points`,
     on the CPU), as a TUM directory (8-bit RGB PNGs, rgb.txt) with the
     lens in its settings, through `cli.main(["run", "--dataset", "tum",
     "--sensor", "mono", ...])`;
 22. mono_kitti: phase 12's directory and settings with `--sensor mono`
     (image_0 only);
 23. stereo_euroc: a room at the EuRoC rig (the rectified pair rendered at
     LEFT.P / RIGHT.P, 752x480, 60 frames; the room's depth range
     EUROC_DEPTH_RANGE, near enough that need_close fires, which this
     phase checks), written as the raw distorted
     mav0/cam0 and cam1 images by inverse rectification (each raw pixel
     normalised with K, undistorted with D, rotated by R, projected with
     P, the render sampled there), with the reference's EuRoC.yaml
     (`Camera.*` as `config.euroc_config`, its LEFT/RIGHT blocks): the
     reader undoes the distortion on the host and the session runs on the
     rectified pair;
 24. mono_euroc: that directory's cam0 with the reference's monocular
     EuRoC.yaml (cam0's own K and D, 1000 features).
     Each of 21-24 has phase 12's checks: >= 80% tracked (mono) under a
     scale-aligned ATE <= min(0.02 m, JAX's + 0.01 m), or >= 90% (stereo)
     under a metric ATE <= min(0.06 m, JAX's + 0.01 m); keyframes within 2
     of the JAX package's on the same directory; the state on the card,
     one graph launch a frame, one FAST launch a frame over 8 (mono) or 16
     (stereo) planes, every pose LM through its kernel; and prints the
     image read ms a frame (host; EuRoC's remaps included), frame ms,
     launches a frame, peak memory, the frames need_close fired on (stereo:
     the close depth points made) and the phase's wall time.  They run
     after phase 14, in its directory.
 25. the reference vocabulary's shape: `wide_vocabulary` grafts two seeded
     levels of 10 under each word of the default tree (k = 10, L = 6,
     1,097,344 nodes, 987,600 words), written in DBoW2's text format
     (`save_orbvoc_text`), parsed by the native parser and by the plain
     Python one (node tables equal, weights within rtol 1e-5), cut at
     depth 5 (99,030 words), both saved as npz; write and parse seconds,
     the file's MB;
 26. phase 5's mono cell (120 frames, captured) at BoW widths 10^4 (the
     default vocabulary), 10^5 and 10^6 (`VocabConfig(depth=...)`,
     `SLAM(vocab_path=...)`): phase 5's gates (one graph launch a frame,
     the state on the card, BoW on every keyframe), each live keyframe's
     kf_bow row equal to the transform on the CPU over its stored
     descriptors (the same words, values within 1e-6), the trajectory
     bit-identical to phase 5's where no relocalisation or loop fired, the
     10^5 run's keyframes within a margin of the JAX package's on the
     same frames (JAX's ATE there is above phase 5's gate); peak memory, kf_bow bytes, the device ms of a
     keyframe frame's dispatch and of a plain frame's (CUDA events around
     each dispatch), the transform's device ms on a keyframe's
     descriptors;
 27. phase 6 (relocalisation) and phase 7 (the loop, open and closed) with
     the 10^6-word tree, and phase 7 at the 10^5 cut held to the JAX
     package's open and closed ATE on the same frames;
 28. the KITTI 00-02 preset (2048 keyframes: a 2048 x 10^6 kf_bow of 8.19
     GB) with the 10^6-word tree through the session API over phase 12's
     directory and settings: phase 12's captured-program checks, the BoW
     rows against the CPU transform, the trajectory bit-identical to phase
     12's where nothing fired; then `detect_loop_candidates` over a seeded
     2048 x 10^6 table with the query planted as a twin and as near twins
     in three groups, in the first, the middle and the last rows of the
     table (`detection_table`): the twin retrieved, a
     candidate from each group, the ids equal to a float64 numpy
     reference's (`detect_reference`), the scores within 1e-5 of its, one
     call of the BoW scoring kernel (csrc/bow_score.cu) over the rows it
     may read; its device ms and its peak memory above the table; last the
     kernel against `table_scores_plain` at the drive's shape (2048 x 10^6,
     186 rows listed, then all) and the desk's (512 x 10^4, 42, then all):
     the same counts, scores within 1e-5, two calls bit-identical, its
     device ms beside its bound (bytes) and the plain version's ms.  The
     sessions' detections count their kernel calls.  Phase 25 runs in a
     process of its own, spawned after phase 4's timings, beside phases
     5-24; phases 26-28 run after phase 24 in that process, where no
     torch.profiler trace has run (`phase_place`), with phase 12's
     directory; they print one JSON line of their numbers
     ("place_recognition") before the card's line.
 Phases 1-19 and 21-28 run the session as users do, so through its
 captured program; the kernels count their own launches on the device, so
 replays count.  Phase 3 also holds FAST bit-exact on the KITTI stereo
 pair's real atlas, on phase 22's KITTI mono frame's and on phase 23's
 rectified EuRoC pair's (16 planes of 752x480), and phase 4 the pose LM on
 an N = 2048 problem recorded in phase 12 and on one recorded in phase 23
 (recorded outside the capture, as the program is warmed up).

Prints the card's name and power limit and a JSON line describing every
ported kernel, then, as the last line, {"ok": true, "device": {...}}.  Exits
non-zero without that line when there is no CUDA device, the package is
missing, or any phase fails.  Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST-9 + NMS arithmetic per level pixel, counted from csrc/fast_nms.cu:
# 16 differences; bright and dark arcs each 44 min/max for the 16 windows of
# 9 (van Herk / Gil-Werman) plus 15 max/min over them; the final 2 max; 8
# NMS max + 1 compare
FAST_OPS_PER_PX = 16 + 2 * (44 + 15) + 2 + 9
# bytes: every level pixel read once (4 B); both padded [G, Hp, Wp] maps
# written once (2 x 4 B a plane pixel, zeros outside the levels included)
FAST_IN_BYTES_PER_PX = 4
FAST_OUT_BYTES_PER_PLANE_PX = 8
# pose-LM f32 operations per active point, counted from csrc/pose_lm.cu: a
# linearization (rotation + translation 33, 1/z and projection and
# residuals 12, chi^2 6, Huber 4, d proj 8, Jacobian rows 36, weight 2,
# 21 H entries x 6, 6 g entries x 6, cost 2 = 267) at each LM iteration's
# trial pose and at each round's start pose (which also reclassifies), and
# the final classification's chi^2 (53) at every point
POSE_OPS_PER_PT_PASS = 267
POSE_OPS_PER_PT_FINAL = 53
# bytes per point: pw 12, uv 8, ur 4, inv sigma^2 4, valid 1, stereo 1 in;
# inlier flag 1 out; per problem T0, T 28 B each, n and chi^2 4 B each
POSE_BYTES_PER_PT = 31
POSE_BYTES_PER_PROBLEM = 64

ATE_GATE_M = 0.02          # test_mono_ate_gate (tests/test_e2e.py)
TRACKED_MIN_FRAC = 0.8
N_FRAMES = 120
DET_FRAMES = 30
LOOP_FRAMES = 140
# bench.py `_run_stereo`: 60 frames; the metric-ATE gates of
# test_stereo_e2e / test_rgbd_e2e (tests/test_e2e.py), >= 90% tracked
STEREO_FRAMES = 60
DEPTH_ATE_GATE_M = {"stereo": 0.06, "rgbd": 0.02}
DEPTH_TRACKED_MIN_FRAC = 0.9
# the first slice's main path (vocabulary off, pose LM in tensor ops) on the
# same card type (PERF.md, NVIDIA H100 80GB HBM3, 700 W): steady fps, frame
# ms p50 / p90 / max
FIRST_SLICE_MAIN = (2.602, 385.12, 447.67, 525.46)
# the second slice's kernels on the same card type (PERF.md, NVIDIA H100
# 80GB HBM3, 700 W): FAST as one frame's 8 per-level launches, the pose LM
# as one block at N = 1024 mono; device ms (torch.profiler) and call ms
# (CUDA events)
SECOND_SLICE_FAST = (0.06769, 0.4420)
SECOND_SLICE_POSE = (0.2028, 0.2665)
CLUSTERS = (1, 2, 4, 8)


# phases 11-15.  Phase 11: the bench mono sequence mapped over frames 0-45,
# then localised over 10-30 on the saved map; ATE gate of a localisation
# run (scale-aligned, tests/test_e2e.py:170-192)
LOC_MAP_FRAMES, LOC_FRAMES = 46, (10, 31)
LOC_ATE_GATE_M = 0.05
# phase 12: a synthetic sequence in the KITTI odometry layout at the
# KITTI 00-02 camera, through the CLI; phase 13 localises on its map over
# KITTI_LOC_FRAMES
KITTI_FRAMES, KITTI_TRAJECTORY = 40, "forward"
KITTI_LOC_FRAMES = (5, 25)
KITTI_TRACKED_MIN_FRAC, KITTI_ATE_GATE_M = 0.9, 0.06
# phase 14: the bench's stereo sequence (its left images and depth maps)
# in the TUM RGB-D layout, through the CLI
TUM_ATE_GATE_M = 0.02
# phase 15: frame batching
BATCH_FRAMES, BATCH = 60, 4
# phase 17: the AR session's frames
AR_FRAMES = 60
# phase 18: S RGB-D sequences stepped together (distributed/dp.py), the
# bench renderer's xyz sequence of seed s for s < S (scripts/
# dp_slam_bench.py --frames 48, at the bench's 500 points); every S runs
# through the captured program (DPProgram), twice: timed, then profiled
# over the same steps (the window from step DP_WARM to the end; the first
# step captures), and eagerly on the same inputs, held bit-identical: the
# eager runs at DP_EAGER's sizes timed, at the others profiled;
# DP_COMPARE's sequences are held against their own S = 1 runs
# (DP_SIZES, DP_FRAMES, DP_WARM are `dp_profile`'s SIZES, FRAMES, WARM,
# set in main once the package is imported)
DP_SIZES = DP_FRAMES = DP_WARM = None
DP_COMPARE, DP_EAGER = 4, (1, 2, 4)
# phase 19: the sharded solvers on 2 gloo ranks of the one card, held to
# the single-rank solver at tests/test_distributed.py's sizes and
# tolerances: observation-sharded BA on 64 cameras x 4,096 points
# (tests/test_ba.py's recipe, seed 11; its iterations), landmark-sharded
# BA on phase 18's sequence-0 map, the pose graph of a 48-node ring (10 LM
# steps of 20 CG iterations, as tests/test_torch_distributed.py: each of
# the pose graph's steps takes ~0.17 s of host time on the card)
SHARD_RANKS = 2
SHARD_BA_ITERS = dict(n_outer=8, n_cg=25)
SHARD_PG_ITERS = dict(n_outer=10, n_cg=20)
SHARD_TOL = {"obs": (1e-4, 1e-3), "pt": (1e-3, 1e-2), "pg": (1e-3, None)}
SHARD_TIMEOUT_S = 600
# the JAX package on the CPU on the same directories and sessions
# (scripts/jax_session_reference.py): phase 11's localisation ATE, phase
# 12's metric ATE and keyframes, phase 14's metric ATE and keyframes.  The
# port must stay within JAX_ATE_MARGIN_M of JAX's ATE (or under the gate,
# whichever is tighter) and within JAX_KF_MARGIN keyframes
JAX_MONO_LOC_ATE = 0.02112
JAX_KITTI = (0.004475, 3)
JAX_TUM = (0.001873, 3)
JAX_ATE_MARGIN_M, JAX_KF_MARGIN = 0.01, 2
# phases 21-24's (ATE, keyframes) from the same script on the CPU,
#   JAX_PLATFORMS=cpu python scripts/jax_session_reference.py tum_mono
#   JAX_PLATFORMS=cpu python scripts/jax_session_reference.py kitti_mono
#   JAX_PLATFORMS=cpu python scripts/jax_session_reference.py \
#       euroc_stereo euroc_mono
# (tracked 118/120, 35/40, 60/60, 59/60 frames)
JAX_TUM_MONO = (0.004290, 10)
JAX_KITTI_MONO = (0.018817, 7)
JAX_EUROC_STEREO = (0.003532, 9)
JAX_EUROC_MONO = (0.002578, 7)
# phases 21-24: the four example paths of the CLI that the phases above do
# not drive, each through `cli.main(["run", ...])` on a directory written in
# its dataset's layout.  21: the bench mono scene (500 points, xyz, seed 0)
# seen through TUM1's fr1 lens (`config.tum1_config`), LENS_FRAMES frames
# (the bench's 120: over 60 the JAX package initialises from frames 0-1
# and ends at a scale-aligned ATE of 0.119 m, over 120 at 0.0043 m), as a
# TUM directory; 22: phase 12's directory read as mono (image_0);
# 23-24: a room at the EuRoC rig, EUROC_FRAMES frames, written as the raw
# distorted cam0/cam1 images, read as stereo (rectified on the host by the
# settings' LEFT/RIGHT blocks) and as mono (cam0, its own lens model).
# Gates: phase 12's (mono: >= TRACKED_MIN_FRAC tracked, scale-aligned ATE
# <= ATE_GATE_M; stereo: >= DEPTH_TRACKED_MIN_FRAC, metric ATE <=
# DEPTH_ATE_GATE_M["stereo"]), each also within JAX_ATE_MARGIN_M of JAX's
# ATE and JAX_KF_MARGIN of its keyframes on the same directory
LENS_FRAMES = N_FRAMES
EUROC_FRAMES = 60
# the room's near and far depth (m, `synthetic.generate`'s depth_range):
# its walls enter the view at ~2.1 x the near depth, so at the default
# (2, 8) no point is closer than ThDepth x baseline = 35 x 0.110 m and
# need_close cannot fire; here it does (scripts/euroc_close_sweep.py)
EUROC_DEPTH_RANGE = (1.3, 4.5)
# fixed-point iterations of the raw images' undistortion (float64): enough
# to converge at the raw corners, where the engine's 8 do not
EUROC_UNDISTORT_ITERS = 50

KITTI_SETTINGS = """%YAML:1.0
# KITTI 00-02 (the reference's Examples/Stereo/KITTI00-02.yaml) with the
# engine's capacities for it
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
TPU.maxKeyframes: 2048
TPU.maxPoints: 131072
"""


def tum_settings(cam) -> str:
    """tests/test_io_ingest.py's YAML keys for camera `cam`, its lens
    (k1 k2 p1 p2 k3) included, at the bench's capacities."""
    return f"""%YAML:1.0
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.k1: {cam.k1}
Camera.k2: {cam.k2}
Camera.p1: {cam.p1}
Camera.p2: {cam.p2}
Camera.k3: {cam.k3}
Camera.width: {cam.width}
Camera.height: {cam.height}
Camera.fps: {cam.fps}
Camera.bf: {cam.bf}
Camera.RGB: 1
ThDepth: {cam.th_depth}
DepthMapFactor: {cam.depth_map_factor}
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
TPU.maxKeypoints: 1024
TPU.maxKeyframes: 512
TPU.maxPoints: 32768
"""


# the reference's Examples/Stereo/EuRoC.yaml rectification blocks (its
# `data:[` without a space included), as tests/test_torch_io.py holds them
EUROC_BLOCKS = """
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0,
          435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
          0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
          -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
          0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
"""
# the reference's Examples/Stereo/EuRoC.yaml (the rectified camera, which
# `config.euroc_config` holds, and the blocks above), with that preset's
# keypoint capacity
EUROC_STEREO_SETTINGS = """%YAML:1.0
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
TPU.maxKeypoints: 1280
""" + EUROC_BLOCKS
# the reference's Examples/Monocular/EuRoC.yaml: cam0's own model (LEFT.K,
# LEFT.D) on the raw images
EUROC_MONO_SETTINGS = """%YAML:1.0
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def write_kitti_dir(root: str, seq, right) -> None:
    """KITTI odometry layout: image_0/ and image_1/ 8-bit gray PNGs,
    times.txt."""
    from orb_slam2_tpu_torch.io.png import write_png
    for sub, imgs in (("image_0", seq.images), ("image_1", right)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, img in enumerate(imgs):
            write_png(os.path.join(root, sub, f"{i:06d}.png"), _u8(img))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6e}\n" for t in seq.timestamps))


def write_tum_mono_dir(root: str, seq) -> None:
    """TUM monocular layout: rgb/ 8-bit RGB PNGs, rgb.txt."""
    from orb_slam2_tpu_torch.io.png import write_png
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rgb = []
    for t, img in zip(seq.timestamps, seq.images):
        rp = f"rgb/{t:.6f}.png"
        write_png(os.path.join(root, rp),
                  np.repeat(_u8(img)[..., None], 3, axis=2))
        rgb.append(f"{t:.6f} {rp}\n")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n" + "".join(rgb))


def write_tum_rgbd_dir(root: str, seq, factor: float) -> None:
    """TUM RGB-D layout: rgb/ 8-bit RGB PNGs, depth/ 16-bit PNGs (metres
    times `factor`), rgb.txt and depth.txt."""
    from orb_slam2_tpu_torch.io.png import write_png
    write_tum_mono_dir(root, seq)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    dep = []
    for t, d in zip(seq.timestamps, seq.depths):
        dp = f"depth/{t:.6f}.png"
        write_png(os.path.join(root, dp), (d * factor).astype(np.uint16))
        dep.append(f"{t:.6f} {dp}\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth images\n# timestamp filename\n" + "".join(dep))


def kitti_sequence(synthetic, cam, n_frames: int = KITTI_FRAMES,
                   trajectory: str = KITTI_TRAJECTORY):
    """The room rendered at the KITTI camera, and its right eye from
    `right_poses` (bench.py's way)."""
    seq = synthetic.generate(cam, n_frames=n_frames, n_points=500,
                             trajectory=trajectory, seed=0)
    right = synthetic.generate(
        cam, n_frames=n_frames, n_points=4, trajectory=trajectory, seed=0,
        poses_override=synthetic.right_poses(seq.poses_twc, cam.baseline))
    return seq, right.images


def write_euroc_dir(root: str, seq, right) -> None:
    """EuRoC MAV layout: mav0/cam0/data/ and mav0/cam1/data/ 8-bit gray
    PNGs named by their timestamps in ns."""
    from orb_slam2_tpu_torch.io.png import write_png
    for cam, imgs in (("cam0", seq.images), ("cam1", right)):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        for t, img in zip(seq.timestamps, imgs):
            write_png(os.path.join(d, f"{round(t * 1e9):019d}.png"), _u8(img))


def canvas_camera(cam, xs, ys, pad: int = 2):
    """A pinhole camera with `cam`'s focal lengths whose image holds every
    pixel position (xs, ys) of `cam`, `pad` px clear of its border for the
    bilinear taps: (that camera, the x and y offsets of `cam`'s pixels in
    its image)."""
    x0 = max(0, int(np.ceil(pad - xs.min())))
    y0 = max(0, int(np.ceil(pad - ys.min())))
    x1 = max(0, int(np.ceil(xs.max() + pad - (cam.width - 1))))
    y1 = max(0, int(np.ceil(ys.max() + pad - (cam.height - 1))))
    return dataclasses.replace(
        cam, cx=cam.cx + x0, cy=cam.cy + y0, width=cam.width + x0 + x1,
        height=cam.height + y0 + y1), x0, y0


def lens_sequence(cam, n_frames: int = LENS_FRAMES):
    """The bench mono scene (500 points, xyz, seed 0) seen through `cam`'s
    lens (k1 k2 p1 p2 k3): rendered by the pinhole camera on a canvas that
    covers the lens's field, then each pixel of the lens's image sampled
    (bilinear) from the render at its undistorted position, which the
    port's `core/camera.undistort_points` gives (on the CPU, the engine's 8
    iterations: the position the session gives a keypoint there).  The
    render's ground truth; no depth maps."""
    from orb_slam2_tpu_torch.core import camera
    from orb_slam2_tpu_torch.io import datasets, synthetic
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float32),
                       np.arange(cam.height, dtype=np.float32))
    K = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy])
    D = torch.tensor([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3])
    g = camera.undistort_points(K, D, torch.as_tensor(np.stack([u, v], -1))
                                ).numpy()
    canvas, x0, y0 = canvas_camera(cam, g[..., 0], g[..., 1])
    seq = synthetic.generate(canvas, n_frames=n_frames, n_points=500,
                             trajectory="xyz", seed=0)
    images = np.stack([datasets.remap_bilinear(im, g[..., 0] + x0,
                                               g[..., 1] + y0)
                       for im in seq.images])
    return dataclasses.replace(seq, images=images, depths=None)


def euroc_calibration():
    """{"LEFT" / "RIGHT": (K [3, 3], D [5], R [3, 3], P [3, 4])} and the
    raw image size (W, H) of EUROC_BLOCKS, read by the port's settings
    reader."""
    from orb_slam2_tpu_torch.io.settings import read_opencv_yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix="_smoke_") as tmp:
        path = os.path.join(tmp, "blocks.yaml")
        with open(path, "w") as f:
            f.write("%YAML:1.0\n" + EUROC_BLOCKS)
        fs = read_opencv_yaml(path)
    return ({side: tuple(np.asarray(fs[f"{side}.{m}"], np.float64)
                         for m in "KDRP") for side in ("LEFT", "RIGHT")},
            (int(fs["LEFT.width"]), int(fs["LEFT.height"])))


def euroc_raw_positions(K, D, R, P, size, iters: int = EUROC_UNDISTORT_ITERS):
    """The rectified pixel (x [H, W], y [H, W]) that each pixel of a raw
    (distorted) EuRoC image sees: normalised with K, undistorted with D
    (k1 k2 p1 p2 k3; float64 fixed point), rotated by R, projected with P:
    the inverse of the undistort-rectify map the reader remaps with."""
    W, H = size
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    xd, yd = (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]
    k1, k2, p1, p2, k3 = np.ravel(D)[:5]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x, y = (xd - (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - x),
                yd - (y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y - y))
    p = np.stack([x, y, np.ones_like(x)], -1) @ (P[:, :3] @ R).T
    return p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]


def euroc_eye(side: str, n_frames: int = EUROC_FRAMES,
              depth_range=EUROC_DEPTH_RANGE):
    """One raw EuRoC camera of a room at the rig (xyz trajectory, seed
    0): the rectified pair's
    camera (LEFT.P; the right eye from `right_poses` at the baseline
    -RIGHT.P[0, 3] / fx) renders on a canvas that covers both raw fields,
    and each raw pixel samples (bilinear) its eye's render at the
    rectified pixel it sees (`euroc_raw_positions`).  "LEFT": the
    sequence, cam0's raw images and the rectified left camera's ground
    truth; "RIGHT": cam1's raw images [F, H, W]."""
    from orb_slam2_tpu_torch import config
    from orb_slam2_tpu_torch.io import datasets, synthetic
    calib, (W, H) = euroc_calibration()
    pos = {s: euroc_raw_positions(*calib[s], (W, H)) for s in calib}
    P, Pr = calib["LEFT"][3], calib["RIGHT"][3]
    cam = config.CameraConfig(fx=float(P[0, 0]), fy=float(P[1, 1]),
                              cx=float(P[0, 2]), cy=float(P[1, 2]), width=W,
                              height=H, fps=20.0, bf=-float(Pr[0, 3]))
    canvas, x0, y0 = canvas_camera(
        cam, np.concatenate([p[0].ravel() for p in pos.values()]),
        np.concatenate([p[1].ravel() for p in pos.values()]))
    poses = synthetic.xyz_trajectory(n_frames)
    seq = synthetic.generate(
        canvas, n_frames=n_frames, n_points=500 if side == "LEFT" else 4,
        trajectory="xyz", seed=0, depth_range=depth_range,
        poses_override=None if side == "LEFT" else
        synthetic.right_poses(poses, cam.baseline))
    px, py = pos[side]
    raw = np.stack([datasets.remap_bilinear(im, px + x0, py + y0)
                    for im in seq.images])
    if side == "RIGHT":
        return raw
    return dataclasses.replace(seq, images=raw, depths=None)


# phases 25-28: place recognition at the reference vocabulary's width.
# The reference loads ORBvoc.txt, a k = 10, L = 6 tree of ~10^6 words
# (System.cc:62), which is not in the repository; `wide_vocabulary` grafts
# WIDE_LEVELS seeded levels of 10 under each word of the package's trained
# default tree (10,984 nodes, 9,876 words, L = 4): 1,097,344 nodes and
# 987,600 words at L = 6, whose top four levels are the trained tree.  A
# grafted child's centroid is its parent's with WIDE_FLIPS seeded bit
# positions flipped; a leaf's weight is its word's plus ln 10 a level.
# Written in DBoW2's text format, parsed by the native parser and held to
# the Python one; parsed again with truncate_depth = 5 for the JAX
# package's at-scale width (99,030 words: the three depth-3 words of the
# default tree put their grafted leaves at depth 5 too).  The BoW width is
# k ** VocabConfig.depth: 10^6 / 10^5 / 10^4.
WIDE_SEED = 0
WIDE_LEVELS = 2
WIDE_FLIPS = 8
WIDE_NODES, WIDE_WORDS = 1_097_344, 987_600
TRUNC_DEPTH = 5
# phase 26: the mono bench run at each width; phase 28: the KITTI preset
# (kitti_config: 2048 keyframes) at 10^6 over phase 12's directory and
# settings, and detection over a 2048 x 10^6 table with planted twins
KITTI_WIDE_FRAMES = KITTI_FRAMES
DETECT_K, DETECT_WORDS_A_ROW = 2048, 300
# the JAX package at the 10^5 cut on the same frames as phases 26 and 27,
#   JAX_PLATFORMS=cpu python scripts/jax_session_reference.py \
#       vocab_mono vocab_reloc vocab_loop
# phase 26's (scale-aligned ATE, keyframes): tracked 119/120, no loop, the
# same bits as its run with the default vocabulary; JAX initialises from
# frames 0 and 2 and ends 0.10 m off, above phase 5's ATE_GATE_M, so the
# 10^5 run is held to JAX's keyframes within JAX_KF_MARGIN and, for its
# ATE, to phase 5's gate alone.  Phase 27's loop (open ATE, closed ATE):
# closed at keyframe 24 of 31; its relocalisation recovered; the port's
# loop is held to <= JAX's ATEs + JAX_ATE_MARGIN_M
JAX_VOCAB_MONO = (0.101874, 9)
JAX_VOCAB_LOOP = (0.170329, 0.153725)


def wide_vocabulary(vocab_mod, base, seed: int = WIDE_SEED,
                    levels: int = WIDE_LEVELS, flips: int = WIDE_FLIPS):
    """`base` (a `place.vocab.Vocabulary`) with `levels` levels of `k`
    children grafted under each word (numpy, from `seed`): each child's
    centroid its parent's with `flips` seeded bit positions flipped (a
    position drawn twice stays), each leaf's weight its base word's plus
    ln k a level.  Node ids: the base's, then the grafted nodes level by
    level, a parent's children together, so a parent precedes its
    children as in DBoW2's files; words in node order."""
    rng = np.random.RandomState(seed)
    k = base.k
    words = np.nonzero(base.word_id >= 0)[0]
    parents_of = [words]
    children = [base.node_children.copy()]
    descs = [base.node_desc]
    n = base.node_children.shape[0]
    for _ in range(levels):
        par = parents_of[-1]
        ids = n + np.arange(len(par) * k, dtype=np.int64)
        grid = np.concatenate(children)
        grid[par] = ids.reshape(-1, k)
        children = [grid, np.full((len(ids), k), -1, np.int32)]
        d = np.concatenate(descs)[np.repeat(par, k)]
        pos = rng.randint(0, 256, (len(ids), flips))
        np.bitwise_xor.at(d, (np.repeat(np.arange(len(ids)), flips),
                              (pos // 8).ravel()),
                          (128 >> (pos % 8)).astype(np.uint8).ravel())
        descs.append(d)
        parents_of.append(ids)
        n += len(ids)
    node_children = np.concatenate(children).astype(np.int32)
    word_id = np.full((n,), -1, np.int32)
    leaves = parents_of[-1]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    weight = (np.repeat(base.word_weight[base.word_id[words]],
                        k ** levels).astype(np.float64)
              + levels * np.log(k)).astype(np.float32)
    return vocab_mod.Vocabulary(
        k=k, depth=base.depth + levels, node_children=node_children,
        node_desc=np.concatenate(descs), word_id=word_id,
        word_weight=weight, n_words=len(leaves), levels_up=base.levels_up)


def read_kitti_positions(path: str) -> np.ndarray:
    """Camera positions [F, 3] of a KITTI-format file (3x4 Twc rows); the
    ATE takes positions only."""
    return np.loadtxt(path, ndmin=2)[:, [3, 7, 11]]


def read_tum_positions(path: str):
    """(timestamps [F], camera positions [F, 3]) of a TUM-format file."""
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, 0], rows[:, 1:4]


class PhaseError(Exception):
    pass


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median over `reps` of one call's time between two CUDA events (the
    device time plus any gap the host leaves while launching)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def queued_ms(fn, reps: int = 30) -> float:
    """Median over `reps` of one call's time between two CUDA events, the
    card kept busy before the first (torch.cuda._sleep, ~0.2 ms) so that the
    host's enqueue is hidden: the device time of the launch, its start on
    the card included."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def replay_ms(fn, reps: int = 30) -> float:
    """One call of `fn` captured as a CUDA graph, as the session's program
    holds it: the median over `reps` replays of the time between two CUDA
    events around one replay."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    out = time_ms(g.replay, reps=reps)
    del g
    return out


def host_us(fn, n: int = 100) -> float:
    """Host microseconds a call takes to enqueue its work (no sync inside)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def device_ms(fn, name: str, reps: int = 20, tries: int = 3):
    """Device time of one launch of the kernel `name`: torch.profiler's
    total over the launches its trace recorded, divided by their number (a
    trace can drop some of `reps` cluster launches), or None when `tries`
    traces record none.  CUDA events around a call also hold the host's
    launch overhead."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = 0.0, 0
        for e in prof.key_averages():
            if name in e.key:
                us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0.0)))
                seen += int(e.count)
        if seen:
            return us / seen / 1e3
    return None


def _dev(d_ms):
    return "not measured" if d_ms is None else f"{d_ms:.5f} ms"


def check_fast(fast_cuda, atlases):
    """Bit-exact all-level kernel vs plain version on each (name, level
    shapes, n_images, atlas) atlas (atlas None: seeded values everywhere,
    also outside the levels, which are never read); timings and bound per
    atlas."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, levels, n_img, atlas in atlases:
        Hp, Wp = levels[0]
        G = len(levels) * n_img
        if atlas is None:
            atlas = torch.rand((G, Hp, Wp), generator=gen,
                               device="cuda") * 255.0
        nms, raw = fast_cuda.fast_nms_atlas_cuda(atlas, levels)
        pn, pr = fast_cuda.fast_nms_atlas_plain(atlas, levels)
        torch.cuda.synchronize()
        err = max(float((nms - pn).abs().max()), float((raw - pr).abs().max()))
        exact = bool(torch.equal(nms, pn)) and bool(torch.equal(raw, pr))
        k_ms = time_ms(lambda: fast_cuda.fast_nms_atlas_cuda(atlas, levels))
        p_ms = time_ms(lambda: fast_cuda.fast_nms_atlas_plain(atlas, levels),
                       reps=5, warm=1)
        call = lambda: fast_cuda.fast_nms_atlas_cuda(atlas, levels)
        d_ms = device_ms(call, "fast_nms_atlas_kernel")
        q_ms, h_us, r_ms = queued_ms(call), host_us(call), replay_ms(call)
        px = n_img * sum(h * w for h, w in levels)
        nbytes = px * FAST_IN_BYTES_PER_PX + \
            G * Hp * Wp * FAST_OUT_BYTES_PER_PLANE_PX
        bytes_s = nbytes / PEAK_BYTES_PER_S
        ops_s = px * FAST_OPS_PER_PX / PEAK_F32_OPS_PER_S
        bound_s = max(bytes_s, ops_s)
        rows.append(dict(name=name, exact=exact, err=err, ms=k_ms,
                         device_ms=d_ms, queued_ms=q_ms, host_us=h_us,
                         replay_ms=r_ms, plain_ms=p_ms,
                         bound_ms=bound_s * 1e3,
                         bound_by="bytes" if bytes_s >= ops_s
                         else "operations"))
        print(f"  fast_nms {name} ({G} planes of {Hp}x{Wp}, {px} level px): "
              f"exact={exact} max_abs_err={err} call {k_ms:.4f} ms (kernel "
              f"on the device {_dev(d_ms)}, queued {q_ms:.5f} ms, host "
              f"{h_us:.1f} us a call, replayed from a graph {r_ms:.5f} "
              f"ms)  plain {p_ms:.4f} ms  bound "
              f"{bound_s * 1e3:.5f} ms ({rows[-1]['bound_by']}: {nbytes} B, "
              f"{px * FAST_OPS_PER_PX} f32 ops)", flush=True)
    return rows


def check_pose_lm(pose_lm_cuda, pose_opt, BAConfig):
    """Kernel vs plain version at the main path's shapes; timings; bound."""
    from orb_slam2_tpu_torch.pose_lm_profile import pose_problem
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg, bf = BAConfig(), 40.0
    problems = []
    for name, B, N, sf in (("N=1024 mono", 1, 1024, 0.0),
                           ("N=1024 third stereo", 1, 1024, 1.0 / 3.0),
                           ("N=1024 all stereo", 1, 1024, 1.0),
                           ("N=64 mono", 1, 64, 0.0),
                           ("B=4 N=1024 mono", 4, 1024, 0.0)):
        problems.append((name, pose_problem(gen, B, N, sf, bf) + (bf, cfg)))
    return check_pose_problems(pose_lm_cuda, pose_opt, problems)


def check_pose_problems(pose_lm_cuda, pose_opt, problems):
    """Each (name, (T0, pw, uv, ur, inv_sigma2, valid, is_stereo, K, bf,
    cfg)) problem, batched [B, N]: kernel vs plain version (pose within
    1e-4, inliers agree on >= 99%, counts within 2, two launches
    bit-identical); timings; bound."""
    rows = []
    for name, args in problems:
        T0, pw, uv, ur, isig, valid, st, K, bf, cfg = args
        B, N = valid.shape
        kT, kinl, kn, kc, kit = pose_lm_cuda.pose_lm_cuda(*args)
        kT2, kinl2, _, _, _ = pose_lm_cuda.pose_lm_cuda(*args)
        plain = [pose_opt.pose_optimize_plain(
            T0[b], pw[b], uv[b], ur[b], isig[b], valid[b], st[b], K, bf, cfg)
            for b in range(B)]
        torch.cuda.synchronize()
        pT = torch.stack([p.T for p in plain])
        err = float((kT - pT).abs().max())
        agree = float((kinl == torch.stack([p.inliers for p in plain])
                       ).float().mean())
        dn = max(abs(int(kn[b]) - int(plain[b].n_inliers)) for b in range(B))
        same = bool(torch.equal(kT, kT2)) and bool(torch.equal(kinl, kinl2))
        k_ms = time_ms(lambda: pose_lm_cuda.pose_lm_cuda(*args))
        p_ms = time_ms(lambda: [pose_opt.pose_optimize_plain(
            T0[b], pw[b], uv[b], ur[b], isig[b], valid[b], st[b], K, bf, cfg)
            for b in range(B)], reps=3, warm=1)
        call = lambda: pose_lm_cuda.pose_lm_cuda(*args)
        d_ms = device_ms(call, "pose_lm_kernel")
        q_ms, h_us, r_ms = queued_ms(call), host_us(call), replay_ms(call)
        # operations this data needs: a linearization over the active
        # points (bounded by the valid ones) at each iteration each problem
        # ran and at each round's start, plus the final classification;
        # and the most the 4 x 10 schedule could need
        n_act = valid.sum(1).to(torch.float64)
        passes = kit.to(torch.float64) + cfg.pose_opt_rounds
        ops = float((n_act * passes * POSE_OPS_PER_PT_PASS +
                     N * POSE_OPS_PER_PT_FINAL).sum())
        ops_max = B * N * ((cfg.pose_opt_iters + 1) * cfg.pose_opt_rounds *
                           POSE_OPS_PER_PT_PASS + POSE_OPS_PER_PT_FINAL)
        nbytes = B * (N * POSE_BYTES_PER_PT + POSE_BYTES_PER_PROBLEM)
        bytes_s = nbytes / PEAK_BYTES_PER_S
        ops_s = ops / PEAK_F32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        rows.append(dict(name=name, err=err, agree=agree, dn=dn, same=same,
                         ms=k_ms, device_ms=d_ms, queued_ms=q_ms,
                         host_us=h_us, replay_ms=r_ms, plain_ms=p_ms,
                         bound_ms=bound_ms,
                         bound_by="bytes" if bytes_s >= ops_s
                         else "operations"))
        print(f"  pose_lm {name} ({int((valid & st).sum())} stereo of "
              f"{int(valid.sum())} valid rows): max_abs_err {err:.3e}, "
              f"inliers agree "
              f"{agree:.4f}, n_inliers within {dn}, two launches "
              f"bit-identical {same}; LM iterations {kit.tolist()}; call "
              f"{k_ms:.4f} ms (kernel on the device {_dev(d_ms)}, queued "
              f"{q_ms:.5f} ms, host {h_us:.1f} us a call, replayed from a "
              f"graph {r_ms:.5f} ms)  plain "
              f"{p_ms:.2f} ms  bound {bound_ms:.6f} ms ({ops:.4g} f32 ops "
              f"this data, {ops_max:.4g} at 4 x 10 iterations; {nbytes} B)",
              flush=True)
        check(err <= 1e-4, f"pose_lm {name}: pose differs by {err}")
        check(agree >= 0.99, f"pose_lm {name}: inliers agree on {agree}")
        check(dn <= 2, f"pose_lm {name}: n_inliers differ by {dn}")
        check(same, f"pose_lm {name}: two launches differ")
    return rows


def sweep_clusters(pose_lm_cuda, pose_opt, BAConfig, libs):
    """The pose LM built with each cluster size, on 8 seeded N = 1024 mono
    problems: pose within 1e-4 of the plain version, device and call
    times, LM iterations."""
    from orb_slam2_tpu_torch.pose_lm_profile import pose_problem
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg, bf = BAConfig(), 40.0
    probs = [pose_problem(gen, 1, 1024, 0.0, bf) for _ in range(8)]
    plain = [pose_opt.pose_optimize_plain(T0[0], pw[0], uv[0], ur[0], isig[0],
                                          valid[0], st[0], K, bf, cfg).T
             for T0, pw, uv, ur, isig, valid, st, K in probs]
    out = {}
    for c, lib in libs.items():
        dev_ms, queued, call_ms, iters = [], [], [], []
        for prob, pT in zip(probs, plain):
            args = tuple(prob) + (bf, cfg)
            T, _, _, _, it = pose_lm_cuda.run(lib, *args)
            torch.cuda.synchronize()
            err = float((T[0] - pT).abs().max())
            check(err <= 1e-4, f"pose_lm cluster {c}: pose differs by {err}")
            call = lambda: pose_lm_cuda.run(lib, *args)
            dev_ms.append(device_ms(call, "pose_lm_kernel"))
            queued.append(queued_ms(call))
            call_ms.append(time_ms(call))
            iters.append(int(it[0]))
        seen = [d for d in dev_ms if d is not None]
        out[c] = dict(device_ms=statistics.mean(seen) if seen else None,
                      queued_ms=statistics.mean(queued),
                      call_ms=statistics.mean(call_ms), iters=iters)
        print(f"  pose_lm cluster of {c} block(s): device ms mean "
              f"{_dev(out[c]['device_ms'])} of {len(seen)} problems "
              f"({', '.join(_dev(d) for d in dev_ms)}), queued mean "
              f"{out[c]['queued_ms']:.5f} ms "
              f"({', '.join(f'{q:.5f}' for q in queued)}), call ms mean "
              f"{out[c]['call_ms']:.4f}; LM iterations {iters}", flush=True)
    return out


def run_slam(SLAM, cfg, seq, stop, start=0, slam=None, right=None, **kw):
    """Track frames [start, stop) of `seq` through the session's entry
    point for its sensor (`right`: the right-eye images of a stereo run)."""
    slam = slam or SLAM(cfg, device="cuda", **kw)
    for f in range(start, stop):
        if cfg.sensor == 1:
            slam.track_stereo(seq.images[f], right[f], seq.timestamps[f])
        elif cfg.sensor == 2:
            slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])
        else:
            slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return slam


def ate_of(slam, seq, evaluate, align_scale=True):
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    return evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                             align_scale=align_scale), len(ie)


def phase_path(name, SLAM, cfg, seq, evaluate, counters, tracked_min,
               ate_gate, right=None):
    """Drive one path through `SLAM` over the whole of `seq` and check it;
    returns (session, kernel launches in that run).  Monocular runs are
    scored with scale alignment, stereo and RGB-D ones in metres."""
    fast_cuda, pose_lm_cuda, pose_opt = counters
    n_frames = len(seq.images)
    mono = cfg.sensor == 0
    # counts zeroed just before the path, read just after (the kernels'
    # own device counts: the session replays its captured program)
    _zero(counters)
    t0 = time.perf_counter()
    slam = run_slam(SLAM, cfg, seq, n_frames, right=right)
    wall = time.perf_counter() - t0
    launches = _read(counters)
    fast_planes = fast_cuda.device_counts()[1]
    stepped = _check_program(name, slam, launches, fast_planes)
    ate, n = ate_of(slam, seq, evaluate, align_scale=mono)
    check(n >= tracked_min * n_frames,
          f"{name}: tracked {n}/{n_frames} frames")
    check(ate <= ate_gate, f"{name}: ATE {ate} m > {ate_gate} m")
    kv = slam.state.kf_valid
    bow_ok = bool((slam.state.kf_bow[kv].abs().sum(1) > 0.99).all())
    check(slam.vocab is not None and bow_ok,
          f"{name}: a keyframe has no BoW vector (vocabulary on)")
    times = [t * 1e3 for t in slam.timings[10:]]
    qs = statistics.quantiles(times, n=10)
    before = (f" (first slice, vocabulary off: fps {FIRST_SLICE_MAIN[0]}, "
              f"p50 {FIRST_SLICE_MAIN[1]} p90 {FIRST_SLICE_MAIN[2]} max "
              f"{FIRST_SLICE_MAIN[3]})") if mono else ""
    print(f"{name}: {n_frames} frames in {wall:.2f} s, steady fps "
          f"{1e3 / statistics.mean(times):.3f}, frame ms p50 "
          f"{statistics.median(times):.2f} p90 {qs[8]:.2f} max "
          f"{max(times):.2f}{before}; tracked {n}/{n_frames}, keyframes "
          f"{int(slam.state.n_kf)} (all with BoW), map points "
          f"{int(slam.state.n_mp)}, {'' if mono else 'metric '}ATE "
          f"{ate:.6f} m; launches fast_nms {launches['fast_nms']} over "
          f"{fast_planes} planes, pose_lm {launches['pose_lm']} ({stepped} "
          f"frames stepped), {slam.graph_replays} graph replays", flush=True)
    return slam, launches


def _check_program(name, slam, launches, fast_planes):
    """A run through the session's captured program: one graph replay a
    dispatch, one FAST launch a frame over every plane of its atlas (the
    levels of one image, or of two for stereo), the state on the card, and
    at least two pose-LM launches for each frame the per-frame step
    tracked: those after the frame that made the initial map (its second
    keyframe for mono, its first for stereo/RGB-D) with a successful
    trajectory row.  Returns that number of frames."""
    mono = slam.cfg.sensor == 0
    planes = slam.cfg.orb.n_levels * (2 if slam.cfg.sensor == 1 else 1)
    check(slam.capture and slam.graph_replays == slam._n_dispatch,
          f"{name}: {slam.graph_replays} graph replays for "
          f"{slam._n_dispatch} dispatches (captured: {slam.capture})")
    check(launches["fast_nms"] == slam.frame_count,
          f"{name}: fast_nms launches {launches['fast_nms']} != one for "
          f"each of {slam.frame_count} frames")
    check(fast_planes == planes * launches["fast_nms"],
          f"{name}: fast_nms covered {fast_planes} planes in "
          f"{launches['fast_nms']} launches, not {planes} each")
    off_card = [f for st in (slam.state, slam.ts) for f, v in
                zip(st._fields, st) if v.device.type != "cuda"]
    check(not off_card, f"{name}: state tensors off the card: {off_card}")
    ok = slam.ts.traj[:slam.frame_count, 15].cpu().numpy() > 0.5
    first = int(slam.state.kf_frame_id[1 if mono else 0])
    stepped = int(ok[first + 1:].sum())
    check(launches["pose_lm"] >= 2 * stepped,
          f"{name}: pose_lm launches {launches['pose_lm']} < 2 x {stepped} "
          "tracked frames")
    return stepped


def phase_depth_path(name, SLAM, cfg, seq, right, evaluate, counters,
                     mapping, pose_opt):
    """Phase 9 / 10: a stereo or RGB-D run at the bench's configuration.
    Also reads the points `create_depth_points` made at the insertions
    (every one after the first keyframe) and records every pose LM's
    problem; returns (launches, the recorded problem with the most stereo
    rows)."""
    recorded = pose_opt.recorded = []
    mapping.depth_points.reset()
    try:
        slam, launches = phase_path(name, SLAM, cfg, seq, evaluate, counters,
                                    DEPTH_TRACKED_MIN_FRAC,
                                    DEPTH_ATE_GATE_M[name.split()[0]], right)
    finally:
        pose_opt.recorded = None
    made = int(mapping.depth_points)
    print(f"  {name}: create_depth_points made {made} points at the "
          f"insertions after the first keyframe", flush=True)
    check(made > 0, f"{name}: no keyframe after the first made depth points")
    n_stereo = [int((a[5] & a[6]).sum()) for a in recorded]
    best = recorded[int(np.argmax(n_stereo))]
    return slam, launches, best


def phase_reloc(SLAM, cfg, synthetic, counters):
    _, pose_lm_cuda, pose_opt = counters
    rcfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    max_frames_hint=6))
    seq = synthetic.generate(cfg.camera, n_frames=60, n_points=300,
                             trajectory="xyz", seed=0)
    slam = run_slam(SLAM, rcfg, seq, 45)
    check(slam.status == 2, f"status {slam.status} after 45 frames")
    kfs = int(slam.state.n_kf)
    check(kfs > 5, f"only {kfs} keyframes before the blind frames")
    # count the kernel launches made inside relocalisation attempts (a
    # host reaction, run eagerly) and their pose_optimize calls
    spent = []
    run_reloc = slam._run_reloc

    def counted(frame):
        calls = []
        inner = _count_calls(pose_opt, "pose_optimize", calls)
        before = pose_lm_cuda.device_launches()
        try:
            out = run_reloc(frame)
        finally:
            pose_opt.pose_optimize = inner
        spent.append(pose_lm_cuda.device_launches() - before)
        check(len(calls) == spent[-1],
              f"a relocalisation attempt made {len(calls)} pose_optimize "
              f"calls but {spent[-1]} kernel launches")
        return out

    slam._run_reloc = counted
    blank = np.zeros_like(seq.images[0])
    for k in range(4):
        slam.track_mono(blank, seq.timestamps[45] + 0.001 * (k + 1))
    slam.flush()
    check(slam.status != 2, "still OK on blank frames")
    run_slam(SLAM, rcfg, seq, 55, start=38, slam=slam)
    check(slam.status == 2, "did not relocalise")
    check(int(slam.state.n_kf) >= kfs, "the map was reset")
    check(spent and all(s == 12 for s in spent),
          f"relocalisation attempts launched {spent} pose LMs, not 12 each "
          "(4 candidates x 3)")
    print(f"relocalisation: recovered after 4 blind frames, keyframes "
          f"{kfs} -> {int(slam.state.n_kf)}, {len(spent)} attempts, "
          f"pose_lm launches per attempt {spent}", flush=True)


def e2e_small_cfg(config):
    """tests/test_e2e.py's small monocular configuration."""
    cam = config.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                              width=320, height=240, fps=30.0, bf=0.0,
                              th_depth=35.0)
    return config.SLAMConfig(
        camera=cam, orb=config.ORBConfig(n_features=500, max_keypoints=512),
        cap=config.Capacity(max_keyframes=96, max_points=6144,
                            max_obs_per_kf=512, max_frames=512,
                            local_ba_points=2048))


def phase_loop(SLAM, cfg, synthetic, evaluate, numbers=None):
    """Phase 7: the loop scenario open and closed (`numbers`, a dict, gets
    both ATEs and the loop's keyframe); returns both runs' per-frame
    records and exported poses."""
    seq = synthetic.generate(cfg.camera, n_frames=LOOP_FRAMES, n_points=300,
                             trajectory="loop", seed=1, loop_revolutions=1.3)
    t0 = time.perf_counter()
    open_loop = run_slam(SLAM, cfg, seq, LOOP_FRAMES,
                         enable_loop_closing=False)
    ate_open, n_open = ate_of(open_loop, seq, evaluate)
    closed = run_slam(SLAM, cfg, seq, LOOP_FRAMES)
    ate_closed, n_closed = ate_of(closed, seq, evaluate)
    print(f"loop closing: open ATE {ate_open:.6f} m ({n_open} tracked), "
          f"closed ATE {ate_closed:.6f} m ({n_closed} tracked), loop at "
          f"keyframe {closed.last_loop_kf} of {int(closed.state.n_kf)}, "
          f"{time.perf_counter() - t0:.1f} s for both", flush=True)
    if numbers is not None:
        numbers.update(open_ate_m=ate_open, closed_ate_m=ate_closed,
                       loop_kf=closed.last_loop_kf,
                       keyframes=int(closed.state.n_kf))
    check(closed.last_loop_kf > 0, "loop closure never fired")
    check(ate_closed <= 1.05 * ate_open,
          f"loop correction hurt: {ate_closed} vs open {ate_open}")
    # the per-frame records (tracked pose, pose relative to the reference
    # keyframe, its id, ok, timestamp) and the exported poses of both runs
    return [r.ts.traj[:LOOP_FRAMES].cpu().numpy() for r in (open_loop, closed)
            ] + [r.poses_twc() for r in (open_loop, closed)]


def phase_loop_again(SLAM, cfg, synthetic, evaluate, first):
    """Phase 7 a second time at the end of the process, after every other
    phase (traces, captures, other sessions): each run's per-frame records
    and exported poses bit-identical to the first time's."""
    again = phase_loop(SLAM, cfg, synthetic, evaluate)
    names = ("open-loop records", "closed-loop records", "open-loop poses",
             "closed-loop poses")
    differ = []
    for name, a, b in zip(names, first, again):
        if a.shape != b.shape or not np.array_equal(a, b):
            rows = np.nonzero((a != b).reshape(len(a), -1).any(1))[0] \
                if a.shape == b.shape else [0]
            differ.append(f"{name} from frame {int(rows[0])}")
    print(f"loop closing again at the end of the process: "
          f"{'; '.join(differ) or 'every record and pose bit-identical to '}"
          f"{'' if differ else 'the first run'}", flush=True)
    check(not differ, f"phase 7 run again differs: {differ}")


def _zero(counters):
    """Zero the kernels' launch counts, which each kernel keeps on the
    device (replays of a captured graph included)."""
    fast_cuda, pose_lm_cuda, _ = counters
    fast_cuda.reset_device_counts()
    pose_lm_cuda.reset_device_launches()


def _read(counters):
    """The kernels' launches since `_zero`, as they counted them on the
    device."""
    fast_cuda, pose_lm_cuda, _ = counters
    return dict(fast_nms=fast_cuda.device_counts()[0],
                pose_lm=pose_lm_cuda.device_launches())


def _check_launched(name, launches, frames):
    """Both kernels launched in the run, at most one FAST launch a
    frame."""
    check(launches["fast_nms"] > 0 and launches["pose_lm"] > 0,
          f"{name}: a kernel was not launched ({launches})")
    check(launches["fast_nms"] <= frames,
          f"{name}: {launches['fast_nms']} FAST launches for {frames} frames")


def _frame_ms(slam, skip=10):
    times = [t * 1e3 for t in slam.timings[skip:]]
    qs = statistics.quantiles(times, n=10)
    return (f"frame ms p50 {statistics.median(times):.2f} p90 {qs[8]:.2f} "
            f"max {max(times):.2f}")


def phase_mono_loc(SLAM, cfg, seq, evaluate, counters, tmp):
    """Phase 11: map the bench mono sequence, save the map, localise a
    fresh session on it over LOC_FRAMES."""
    slam = run_slam(SLAM, cfg, seq, LOC_MAP_FRAMES)
    path = os.path.join(tmp, "mono_map.npz")
    slam.save_map(path)
    n_kf, n_mp = int(slam.state.n_kf), int(slam.state.n_mp)
    loc = SLAM(cfg, device="cuda")
    loc.load_map(path)
    loc.activate_localization_mode()
    _zero(counters)
    a, b = LOC_FRAMES
    run_slam(SLAM, cfg, seq, b, start=a, slam=loc)
    launches = _read(counters)
    ate, n = ate_of(loc, seq, evaluate)
    print(f"mono localisation: map of frames 0-{LOC_MAP_FRAMES - 1} "
          f"({n_kf} keyframes, {n_mp} points) saved and loaded; frames "
          f"{a}-{b - 1} tracked {n}/{b - a}, status {loc.status}, keyframes "
          f"{int(loc.state.n_kf)}, points {int(loc.state.n_mp)}, "
          f"scale-aligned ATE {ate:.6f} m (JAX on the CPU "
          f"{JAX_MONO_LOC_ATE}); launches {launches}", flush=True)
    check(loc.status == 2, f"mono localisation: status {loc.status}")
    check(int(loc.state.n_kf) == n_kf and int(loc.state.n_mp) == n_mp,
          "mono localisation changed the map")
    check(n == b - a, f"mono localisation tracked {n}/{b - a}")
    check(ate <= LOC_ATE_GATE_M, f"mono localisation ATE {ate} m")
    _check_launched("mono localisation", launches, b - a)
    return launches


def phase_kitti(port_cli, mapping, tracking, pose_opt, evaluate, counters,
                kseq, kright, tmp):
    """Phase 12: the KITTI preset through the CLI on a KITTI-layout
    directory.  Reads the counts of the frames need_close fired on and of
    the close points create_depth_points made; records the pose LMs'
    problems."""
    root = os.path.join(tmp, "kitti_00")
    t0 = time.perf_counter()
    write_kitti_dir(root, kseq, kright)
    yaml = os.path.join(tmp, "kitti.yaml")
    with open(yaml, "w") as f:
        f.write(KITTI_SETTINGS)
    print(f"KITTI directory: {2 * len(kseq.images)} PNGs of 1241x376 "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    recorded = pose_opt.recorded = []
    tracking.need_close_frames.reset()
    mapping.depth_points.reset()
    mapping.close_depth_points.reset()
    out = os.path.join(tmp, "kitti_traj.txt")
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    try:
        t0 = time.perf_counter()
        slam = port_cli.main(["run", "--dataset", "kitti", "--sensor",
                              "stereo", "--path", root, "--settings", yaml,
                              "--output", out])
        wall = time.perf_counter() - t0
    finally:
        pose_opt.recorded = None
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    est = read_kitti_positions(out)
    ie, ig = evaluate.match_timestamps(slam.timestamps(), kseq.timestamps)
    check(len(est) == len(ie), "KITTI file and session disagree")
    ate = evaluate.ate_rmse(est[ie], kseq.poses_twc[ig], align_scale=False)
    n_frames = len(kseq.images)
    n_close = int(tracking.need_close_frames)
    made = int(mapping.close_depth_points)
    n_kf = int(slam.state.n_kf)
    print(f"KITTI preset via the CLI ({KITTI_TRAJECTORY}, {n_frames} "
          f"frames, 1241x376, 2000 features, 2048 keyframes x 2048 "
          f"keypoints, 131,072 points): {wall:.2f} s, tracked {len(ie)}/"
          f"{n_frames}, metric ATE {ate:.6f} m, keyframes {n_kf}, map "
          f"points {int(slam.state.n_mp)} (JAX on the CPU: ATE "
          f"{JAX_KITTI[0]} m, {JAX_KITTI[1]} keyframes); need_close fired "
          f"on {n_close} frames; close depth points made {made} (of "
          f"{int(mapping.depth_points)} depth points); "
          f"{_frame_ms(slam)}; launches {launches} "
          f"({launches['fast_nms'] / n_frames:.2f} FAST, "
          f"{launches['pose_lm'] / n_frames:.2f} pose LM a frame); peak "
          f"memory {peak / 2**30:.3f} GiB", flush=True)
    check(len(ie) >= KITTI_TRACKED_MIN_FRAC * n_frames,
          f"KITTI: tracked {len(ie)}/{n_frames}")
    check(ate <= min(KITTI_ATE_GATE_M, JAX_KITTI[0] + JAX_ATE_MARGIN_M),
          f"KITTI: ATE {ate} m (JAX {JAX_KITTI[0]})")
    check(abs(n_kf - JAX_KITTI[1]) <= JAX_KF_MARGIN,
          f"KITTI: {n_kf} keyframes (JAX {JAX_KITTI[1]})")
    check(made > 0, "KITTI: no close depth point was made")
    _check_launched("KITTI", launches, n_frames)
    n_valid = [int(a[5].sum()) for a in recorded]
    best = recorded[int(np.argmax(n_valid))]
    check(best[1].shape[0] == 2048, "KITTI: pose LM problems not N = 2048")
    return slam, root, launches, best


def phase_kitti_loc(SLAM, datasets, tracking, counters, kslam, root,
                    evaluate, kseq, tmp):
    """Phase 13: the KITTI map saved, loaded in a fresh session, localised
    over KITTI_LOC_FRAMES with VO points."""
    path = os.path.join(tmp, "kitti_map.npz")
    kslam.save_map(path)
    loc = SLAM(kslam.cfg, device="cuda")
    loc.load_map(path)
    loc.activate_localization_mode()
    n_kf, n_mp = int(loc.state.n_kf), int(loc.state.n_mp)
    tracking.vo_candidates.reset()
    tracking.vo_inliers.reset()
    a, b = KITTI_LOC_FRAMES
    _zero(counters)
    reader = datasets.SequenceReader(
        datasets.load_kitti_stereo(root)[a:b], "stereo")
    for left, right, t in reader:
        loc.track_stereo(left, right, t)
    loc.flush()
    launches = _read(counters)
    cand, used = int(tracking.vo_candidates), int(tracking.vo_inliers)
    ate, n = ate_of(loc, kseq, evaluate, align_scale=False)
    print(f"KITTI stereo localisation: frames {a}-{b - 1} on the saved map "
          f"({n_kf} keyframes): tracked {n}/{b - a}, status {loc.status}, "
          f"metric ATE {ate:.6f} m, keyframes {int(loc.state.n_kf)}; VO "
          f"points: {cand} candidates, {used} used as pose-LM inliers; "
          f"launches {launches}", flush=True)
    check(loc.status == 2, f"KITTI localisation: status {loc.status}")
    check(int(loc.state.n_kf) == n_kf and int(loc.state.n_mp) == n_mp,
          "KITTI localisation changed the map")
    check(used > 0, "KITTI localisation used no VO point")
    _check_launched("KITTI localisation", launches, b - a)
    return launches


def phase_tum(port_cli, evaluate, counters, seq, cam, tmp):
    """Phase 14: the bench's stereo sequence (left images, depth maps) in
    the TUM RGB-D layout through the CLI; the keyframe trajectory file."""
    root = os.path.join(tmp, "tum_rgbd")
    write_tum_rgbd_dir(root, seq, cam.depth_map_factor)
    yaml = os.path.join(tmp, "tum.yaml")
    with open(yaml, "w") as f:
        f.write(tum_settings(cam))
    out = os.path.join(tmp, "tum_traj.txt")
    _zero(counters)
    slam = port_cli.main(["run", "--dataset", "tum", "--sensor", "rgbd",
                          "--path", root, "--settings", yaml, "--output",
                          out])
    launches = _read(counters)
    ts, est = read_tum_positions(out)
    ie, ig = evaluate.match_timestamps(ts, seq.timestamps)
    ate = evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=False)
    kf_path = os.path.join(tmp, "tum_kf.txt")
    slam.save_keyframe_trajectory_tum(kf_path)
    kf_lines = len(np.loadtxt(kf_path, ndmin=2))
    n_kf, n_frames = int(slam.state.n_kf), len(seq.images)
    print(f"TUM RGB-D layout via the CLI: tracked {len(ie)}/{n_frames}, "
          f"metric ATE {ate:.6f} m, keyframes {n_kf} ({kf_lines} lines in "
          f"the keyframe trajectory), map points {int(slam.state.n_mp)} (JAX "
          f"on the CPU: ATE {JAX_TUM[0]} m, {JAX_TUM[1]} keyframes); "
          f"{_frame_ms(slam)}; launches {launches}", flush=True)
    check(len(ie) >= DEPTH_TRACKED_MIN_FRAC * n_frames,
          f"TUM: tracked {len(ie)}/{n_frames}")
    check(ate <= min(TUM_ATE_GATE_M, JAX_TUM[0] + JAX_ATE_MARGIN_M),
          f"TUM: ATE {ate} m")
    check(abs(n_kf - JAX_TUM[1]) <= JAX_KF_MARGIN,
          f"TUM: {n_kf} keyframes (JAX {JAX_TUM[1]})")
    check(kf_lines == n_kf, f"TUM: {kf_lines} keyframe lines for {n_kf}")
    _check_launched("TUM", launches, n_frames)
    return launches


def phase_example(name, key, port_cli, mapping, tracking, evaluate,
                  counters, tmp, seq, dataset, sensor, root, settings,
                  jax_ref, write=None, record=False, need_close=False):
    """Phases 21-24: one example path, `cli.main(["run", "--dataset",
    dataset, "--sensor", sensor, ...])` on the directory `root` (written
    first by `write(root)` when given) with the settings text `settings`,
    the kernels' counts zeroed just before and read just after.  Phase
    12's checks (tracked share, ATE under the gate and within
    JAX_ATE_MARGIN_M of JAX's, keyframes within JAX_KF_MARGIN of JAX's;
    `jax_ref` = (ATE, keyframes), None: no JAX reference to hold the run
    to) and the captured program's
    (`_check_program`).  Prints the image read and frame ms, launches a
    frame, peak memory, the frames need_close fired on (stereo: the close
    depth points made) and the phase's wall time; with `need_close`, fails
    unless need_close fired and close depth points were made.  Returns
    (launches, the recorded pose-LM problem with the most stereo rows when
    `record`)."""
    fast_cuda, _, pose_opt = counters
    t_phase = time.perf_counter()
    if write is not None:
        write(root)
    yaml = os.path.join(tmp, f"{key}.yaml")
    with open(yaml, "w") as f:
        f.write(settings)
    out = os.path.join(tmp, f"{key}_traj.txt")
    mono = sensor == "mono"
    recorded = pose_opt.recorded = [] if record else None
    tracking.need_close_frames.reset()
    mapping.depth_points.reset()
    mapping.close_depth_points.reset()
    log = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            slam = port_cli.main(["run", "--dataset", dataset, "--sensor",
                                  sensor, "--path", root, "--settings", yaml,
                                  "--output", out])
        wall = time.perf_counter() - t0
    finally:
        pose_opt.recorded = None
    launches = _read(counters)
    fast_planes = fast_cuda.device_counts()[1]
    peak = torch.cuda.max_memory_allocated()
    read_ms = float(re.search(r"image read ([0-9.]+) ms/frame",
                              log.getvalue()).group(1))
    if dataset == "kitti":
        ts, est = slam.timestamps(), read_kitti_positions(out)
    else:
        ts, est = read_tum_positions(out)
    check(len(est) == len(slam.timestamps()),
          f"{name}: the trajectory file and the session disagree")
    ie, ig = evaluate.match_timestamps(ts, seq.timestamps)
    ate = evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=mono) \
        if len(ie) >= 3 else float("inf")
    n_frames, n_kf = len(seq.timestamps), int(slam.state.n_kf)
    n_close = int(tracking.need_close_frames)
    made = "" if mono else (
        f", close depth points made {int(mapping.close_depth_points)} (of "
        f"{int(mapping.depth_points)} depth points)")
    cam = slam.cfg.camera
    print(f"{name}: {n_frames} frames of {cam.width}x{cam.height}, "
          f"{slam.cfg.orb.n_features} features, in {wall:.2f} s: tracked "
          f"{len(ie)}/{n_frames}, {'scale-aligned' if mono else 'metric'} "
          f"ATE {ate:.6f} m, keyframes {n_kf}, map points "
          f"{int(slam.state.n_mp)} ("
          + ("no JAX reference" if jax_ref is None else
             f"JAX on the CPU: ATE {jax_ref[0]} m, {jax_ref[1]} keyframes")
          + f"); need_close fired on {n_close} "
          f"frames{made}; image read {read_ms:.2f} ms a frame (host), "
          f"{_frame_ms(slam)}; launches {launches} "
          f"({launches['fast_nms'] / n_frames:.2f} FAST over "
          f"{fast_planes // max(launches['fast_nms'], 1)} planes, "
          f"{launches['pose_lm'] / n_frames:.2f} pose LM a frame), "
          f"{slam.graph_replays} graph replays; peak memory "
          f"{peak / 2**30:.3f} GiB; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print("".join(f"  | {ln}\n" for ln in log.getvalue().splitlines()),
          end="", flush=True)
    _check_program(name, slam, launches, fast_planes)
    tracked_min = TRACKED_MIN_FRAC if mono else DEPTH_TRACKED_MIN_FRAC
    check(len(ie) >= tracked_min * n_frames,
          f"{name}: tracked {len(ie)}/{n_frames}")
    gate = ATE_GATE_M if mono else DEPTH_ATE_GATE_M["stereo"]
    if jax_ref is not None:
        gate = min(gate, jax_ref[0] + JAX_ATE_MARGIN_M)
        check(abs(n_kf - jax_ref[1]) <= JAX_KF_MARGIN,
              f"{name}: {n_kf} keyframes (JAX {jax_ref[1]})")
    check(ate <= gate, f"{name}: ATE {ate} m > {gate} m")
    check(not need_close or (n_close > 0 and
                             int(mapping.close_depth_points) > 0),
          f"{name}: need_close fired on {n_close} frames")
    best = None
    if record:
        n_stereo = [int((a[5] & a[6]).sum()) for a in recorded]
        best = recorded[int(np.argmax(n_stereo))]
    return launches, best


# ---------------------------------------------------------------------------
# 25-28: place recognition at the reference vocabulary's width
# ---------------------------------------------------------------------------

def _trees_equal(a, b, weight_rtol):
    """The node tables exactly, the word weights within weight_rtol; the
    first differing field's name, or None."""
    for f in ("node_children", "node_desc", "word_id"):
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or not np.array_equal(x, y):
            return f
    if (a.k, a.depth, a.n_words) != (b.k, b.depth, b.n_words):
        return "k, depth or n_words"
    if not np.allclose(a.word_weight, b.word_weight, rtol=weight_rtol,
                       atol=0):
        return "word_weight"
    return None


def phase_vocab_text(tmp):
    """Phase 25, run in a process of its own beside phases 5-24 (it prints
    its line when it ends): the wide tree made from WIDE_SEED, written in
    DBoW2's text format into `tmp`, parsed by the native parser and by the
    plain Python one (held equal: node tables exactly, weights within rtol
    1e-5) and again cut at TRUNC_DEPTH; both saved as the npz
    `SLAM(vocab_path=)` reads.  Returns ({depth: npz path}, the
    numbers)."""
    from orb_slam2_tpu_torch.pipeline.system import DEFAULT_VOCAB
    from orb_slam2_tpu_torch.place import vocab as vocab_mod
    base = vocab_mod.Vocabulary.load(DEFAULT_VOCAB)
    t0 = time.perf_counter()
    wide = wide_vocabulary(vocab_mod, base)
    make_s = time.perf_counter() - t0
    txt = os.path.join(tmp, "ORBvoc_wide.txt")
    t0 = time.perf_counter()
    vocab_mod.save_orbvoc_text(wide, txt)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(txt) / 1e6
    t0 = time.perf_counter()
    nat = vocab_mod.load_orbvoc_text(txt, levels_up=2, native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = vocab_mod.load_orbvoc_text(txt, levels_up=2, native=False)
    python_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut = vocab_mod.load_orbvoc_text(txt, levels_up=2,
                                     truncate_depth=TRUNC_DEPTH, native=True)
    trunc_s = time.perf_counter() - t0
    n_nodes = nat.node_children.shape[0]
    print(f"ORBvoc text (k = {nat.k}, L = {nat.depth}; in a process of "
          f"its own beside phases 5-24): made in {make_s:.2f} s, "
          f"{n_nodes} nodes, {nat.n_words} words, written in "
          f"{write_s:.2f} s ({mb:.1f} MB); parsed natively in "
          f"{native_s:.2f} s, by the plain Python parser in "
          f"{python_s:.2f} s; cut at depth {TRUNC_DEPTH} in {trunc_s:.2f} "
          f"s: {cut.n_words} words", flush=True)
    differ = _trees_equal(nat, py, 1e-5)
    check(differ is None, f"ORBvoc: native and Python parses differ in "
          f"{differ}")
    wide.node_desc[0] = 0            # the root's centroid is not written
    differ = _trees_equal(nat, wide, 1e-6)
    check(differ is None, f"ORBvoc: the parse differs from the tree "
          f"written in {differ}")
    check((n_nodes, nat.n_words, nat.k, nat.depth) ==
          (WIDE_NODES, WIDE_WORDS, 10, 6),
          f"ORBvoc: {n_nodes} nodes, {nat.n_words} words, k {nat.k}, L "
          f"{nat.depth}")
    n0 = base.node_children.shape[0]
    check(np.array_equal(nat.node_desc[1:n0], base.node_desc[1:]),
          "ORBvoc: the top levels are not the trained tree")
    check(cut.depth == TRUNC_DEPTH and cut.n_words <= 10 ** TRUNC_DEPTH,
          f"ORBvoc cut: depth {cut.depth}, {cut.n_words} words")
    paths = {}
    for v in (nat, cut):
        paths[v.depth] = os.path.join(tmp, f"vocab_1e{v.depth}.npz")
        v.save(paths[v.depth])
    return paths, dict(
        nodes=n_nodes, words=nat.n_words, words_1e5=cut.n_words,
        file_mb=mb, write_s=write_s, native_parse_s=native_s,
        python_parse_s=python_s, truncate_parse_s=trunc_s)


# cycles (~2 ms) the card sleeps before each timed dispatch, so that the
# host has enqueued the dispatch before its first event is reached
SPAN_SLEEP_CYCLES = 4_000_000


def timed_session(SLAM):
    """`SLAM` recording CUDA events around each dispatch of the captured
    program (its input copies and its graph replay: the frame's device
    time, the card kept busy before the first event as `queued_ms` does,
    so that the host's enqueue is not counted) and counting the
    relocalisation attempts.  Its spans read the device only in a process
    that has run no torch.profiler trace (`phase_place`)."""
    class TimedSLAM(SLAM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spans = []
            self.reloc_attempts = 0

        def _dispatch_batch(self):
            fid = self._batch[0][1] if self._batch else None
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPAN_SLEEP_CYCLES)
            a.record()
            super()._dispatch_batch()
            b.record()
            if fid is not None:
                self.spans.append((fid, a, b))

        def _run_reloc(self, frame):
            self.reloc_attempts += 1
            return super()._run_reloc(frame)

    return TimedSLAM


def frame_spans(slam, n_st):
    """The device ms of each keyframe frame's dispatch, in frame order,
    and of each plain frame's: keyframe frames insert (their step also
    runs the first integration stage), plain ones neither insert nor run
    a stage; the first dispatch (the capture) is left out."""
    torch.cuda.synchronize()
    kf = slam.state.kf_frame_id.cpu().numpy()
    kf = set(kf[kf >= 0].tolist())
    busy = {f + d for f in kf for d in range(n_st)}
    ins, plain = [], []
    for fid, a, b in slam.spans[1:]:
        (ins if fid in kf else plain if fid not in busy else []).append(
            a.elapsed_time(b))
    return ins, plain


def span_text(ins, plain):
    """The spans of `frame_spans` as printed."""
    return (f"device ms of each keyframe frame "
            f"{[round(x, 3) for x in ins]}, of a plain frame median "
            f"{statistics.median(plain):.3f} min {min(plain):.3f} "
            f"({len(plain)})")


def check_bow_rows(name, slam, transform_cpu):
    """Each live keyframe's BoW row on the card against the same transform
    on the CPU over the keyframe's stored descriptors: the same words, the
    values within 1e-6.  Returns the rows checked."""
    kv = slam.state.kf_valid.cpu().numpy()
    ids = np.nonzero(kv)[0]
    worst = 0.0
    for k in ids:
        want = transform_cpu(slam.state.kf_desc[k].cpu(),
                             slam.state.kf_kp_valid[k].cpu())[0]
        got = slam.state.kf_bow[k].cpu()
        check(torch.equal(got > 0, want > 0),
              f"{name}: keyframe {k}'s BoW words differ from the CPU "
              "transform's")
        worst = max(worst, float((got - want).abs().max()))
    check(worst <= 1e-6, f"{name}: a BoW row is {worst} from the CPU "
          "transform's")
    return len(ids), worst


def run_record(slam):
    """What `_same_run` compares of a session, kept on the host."""
    n = slam.frame_count
    return types.SimpleNamespace(
        frame_count=n, traj=slam.ts.traj[:n].cpu(),
        poses=slam.poses_twc(), n_kf=int(slam.state.n_kf))


def _same_run(slam, ref):
    """Whether `slam` has `ref`'s (a `run_record`) per-frame records and
    exported poses bit for bit: None, or what differs."""
    n = slam.frame_count
    if n != ref.frame_count:
        return f"frame counts {n} vs {ref.frame_count}"
    ra = slam.ts.traj[:n].cpu()
    if not torch.equal(ra, ref.traj):
        rows = torch.nonzero((ra != ref.traj).any(1))[:, 0]
        return f"per-frame records from frame {int(rows[0])}"
    pa = slam.poses_twc()
    if pa.shape != ref.poses.shape or not np.array_equal(pa, ref.poses):
        return "exported poses"
    return None


def phase_vocab_mono(SLAM, config, system, vocab_mod, seq, evaluate,
                     counters, paths, vocabs, ref):
    """Phase 26: the mono bench sequence (phase 5's cell) captured at BoW
    widths 10^4 (the default vocabulary), 10^5 and 10^6 (the wide tree and
    its cut): phase 5's gates, every keyframe's BoW row equal to the CPU
    transform's, the trajectory bit-identical to phase 5's run `ref` where
    no relocalisation or loop fired, the 10^5 run's keyframes within
    JAX_KF_MARGIN of JAX's on the same frames; peak memory, kf_bow bytes, the device ms of a
    keyframe frame and of a plain frame, the transform's device ms on a
    keyframe's descriptors.  Returns ({path: launches}, {width: numbers})."""
    launches, out = {}, {}
    Timed = timed_session(SLAM)
    for depth, vpath in ((4, system.DEFAULT_VOCAB), (5, paths[5]),
                         (6, paths[6])):
        W = 10 ** depth
        cfg = config.SLAMConfig(vocab=config.VocabConfig(depth=depth))
        name = f"mono at 10^{depth} words"
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        slam, launches[f"mono_1e{depth}"] = phase_path(
            name, lambda c, **kw: Timed(c, vocab_path=vpath, **kw), cfg,
            seq, evaluate, counters, TRACKED_MIN_FRAC, ATE_GATE_M)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        vocab = vocabs.get(depth) or vocab_mod.Vocabulary.load(vpath)
        rows, worst = check_bow_rows(name, slam, vocab_mod.build_transform(
            vocab, pad_to=W, device="cpu"))
        kv = slam.state.kf_valid.nonzero()[:, 0]
        k = int(kv[-1])
        desc, valid = slam.state.kf_desc[k], slam.state.kf_kp_valid[k]
        tr_ms = replay_ms(lambda: slam._transform(desc, valid))
        tr_mb = (vocab.node_children.nbytes + vocab.node_desc.nbytes +
                 vocab.word_id.nbytes + vocab.word_weight.nbytes) / 1e6
        ins, plain = frame_spans(slam, system.n_stages(cfg))
        fired = slam.reloc_attempts > 0 or slam.last_loop_kf >= 0
        differ = _same_run(slam, ref)
        ate, n = ate_of(slam, seq, evaluate)
        init_frames = slam.state.kf_frame_id[:2].tolist()
        out[W] = dict(peak_gib=peak, kf_bow_bytes=slam.state.kf_bow.numel()
                      * 4, transform_ms=tr_ms, transform_mb=tr_mb,
                      keyframe_frame_ms=ins,
                      plain_frame_ms=statistics.median(plain),
                      ate_m=ate, tracked=n, keyframes=int(slam.state.n_kf),
                      bow_rows=rows, bow_err=worst,
                      relocs=slam.reloc_attempts, loop_kf=slam.last_loop_kf,
                      init_frames=init_frames)
        print(f"  {name}: peak {peak:.3f} GiB above the process's "
              f"{base_mem / 2 ** 30:.3f}, kf_bow {W * slam.state.kf_bow.shape[0] * 4 / 1e9:.3f} GB; "
              f"{span_text(ins, plain)}; transform "
              f"{tr_ms:.4f} ms on {int(valid.sum())} descriptors (tree "
              f"{tr_mb:.1f} MB); {rows} BoW rows equal the CPU transform's "
              f"(max err {worst:.2e}); relocalisation attempts "
              f"{slam.reloc_attempts}, loop at keyframe {slam.last_loop_kf}; "
              f"initialised from frames {init_frames}; "
              f"{'bit-identical to phase 5' if differ is None else 'differs from phase 5: ' + differ}",
              flush=True)
        check(fired or differ is None,
              f"{name}: nothing fired, yet the run differs from phase 5's "
              f"in {differ}")
        if depth == TRUNC_DEPTH:
            check(abs(int(slam.state.n_kf) - JAX_VOCAB_MONO[1]) <=
                  JAX_KF_MARGIN, f"{name}: {int(slam.state.n_kf)} keyframes "
                  f"(JAX {JAX_VOCAB_MONO[1]})")
        del slam
    return launches, out


def phase_vocab_scenarios(SLAM, config, synthetic, evaluate, counters,
                          paths):
    """Phase 27: phase 6's relocalisation and phase 7's loop with the wide
    tree (10^6 words), and the loop again at the 10^5 cut, each held to
    its phase's gates; at 10^5 also to the JAX package's open and closed
    ATE on the same frames.  Returns {width: the loop's numbers}."""
    out = {}
    for depth in (6, TRUNC_DEPTH):
        vcfg = config.VocabConfig(depth=depth)
        S = lambda c, vp=paths[depth], **kw: SLAM(c, vocab_path=vp, **kw)
        if depth == 6:
            # the JAX package recovers here at 10^5 words
            phase_reloc(S, config.SLAMConfig(vocab=vcfg), synthetic,
                        counters)
        nums = {}
        phase_loop(S, e2e_small_cfg(config).replace(vocab=vcfg), synthetic,
                   evaluate, nums)
        print(f"  (phases 6-7 at 10^{depth} words)", flush=True)
        if depth == TRUNC_DEPTH:
            for key, want in zip(("open_ate_m", "closed_ate_m"),
                                 JAX_VOCAB_LOOP):
                check(nums[key] <= want + JAX_ATE_MARGIN_M,
                      f"loop at 10^{depth} words: {key} {nums[key]} m, JAX "
                      f"{want} m")
        out[10 ** depth] = nums
    return out


def detect_reference(rows_idx, rows_val, q, valid, covis, query, min_score,
                     n_out=8, shared_frac=0.8, acc_frac=0.75, min_w=15):
    """`place.database.detect_loop_candidates` in float64 numpy over a
    table held as rows of (word, value) pairs (rows_idx, rows_val [K, L],
    value 0 = no word) and a dense query q [W]: the candidate ids and
    their scores."""
    K = len(rows_idx)
    qv = q[rows_idx]
    both = (qv > 0) & (rows_val > 0)
    sw = both.sum(1)
    # |q - b|_1 = |q|_1 + |b|_1 - 2 sum min(q, b) over the shared words
    l1 = q.sum() + rows_val.sum(1) - 2 * np.where(
        both, np.minimum(qv, rows_val), 0).sum(1)
    scores = 1.0 - 0.5 * l1
    ok = valid & (np.arange(K) != query) & ~(covis[query] >= min_w)
    sw = np.where(ok, sw, 0)
    min_cw = int(shared_frac * sw.max())
    cand = ok & (sw > min_cw) & (sw > 0) & (scores >= min_score)
    w = np.where(valid[None] & valid[:, None], covis, 0)
    top_idx = np.argsort(-w, axis=1, kind="stable")[:, :10]
    top_w = np.take_along_axis(w, top_idx, 1)
    member = cand[top_idx] & (top_w > 0)
    acc = np.where(cand, scores, 0.0) + np.where(member, scores[top_idx],
                                                 0.0).sum(1)
    mval = np.where(member, scores[top_idx], -np.inf)
    marg = top_idx[np.arange(K), mval.argmax(1)]
    best = np.where(mval.max(1) > np.where(cand, scores, -np.inf), marg,
                    np.arange(K))
    acc = np.where(cand, acc, -np.inf)
    keep = acc > acc_frac * acc.max()
    seen = np.full(K, -np.inf)
    for r, s in zip(best[keep], acc[keep]):
        seen[r] = max(seen[r], s)
    order = np.argsort(-seen, kind="stable")[:n_out]
    return np.where(np.isfinite(seen[order]), order, -1), seen[order]


# detection's planted rows (row, share of the query's words kept; None: an
# exact twin) in covisibility groups (a chain of pairs each) spread over
# the table: its first rows, the middle and the last rows (2010-2047; the
# chunks of 67 rows the plain version gathers at 10^6 words: the first,
# the middle one and the last, partial, one).
# Each group scores about as high as the others, so that one candidate of
# each is kept; rows 42 and 43, in no group, are cut.
DETECT_TWINS = ((17, None), (40, 1.0), (41, 0.97), (42, 0.93), (43, 0.9),
                (1000, 1.0), (1001, 0.97), (1002, 0.93),
                (2030, 1.0), (2040, 0.97), (2047, 0.93))
DETECT_GROUPS = ((17, 40, 41), (1000, 1001, 1002), (2030, 2040, 2047))
DETECT_SCORE_ATOL = 1e-5


def detection_table(query_bow, K=DETECT_K, per_row=DETECT_WORDS_A_ROW,
                    seed=WIDE_SEED):
    """A seeded K x W keyframe BoW table as tests/test_vocab_scale.py and
    scripts/profile_detect_scale.py build it (per_row random words a row,
    L1-normalised; a word drawn twice in a row counts once), the query
    vector planted as the rows of DETECT_TWINS (a twin: the query itself;
    a near twin: that share of its words at perturbed values), the rows
    of each of DETECT_GROUPS covisible in a chain, and rows 100 and 3
    covisible.  Returns (rows_idx, rows_val [K, L] numpy, covis)."""
    rng = np.random.RandomState(seed)
    W = query_bow.shape[0]
    idx = np.sort(rng.randint(0, W, (K, per_row)), axis=1)
    val = rng.rand(K, per_row).astype(np.float32)
    val[:, 1:][idx[:, 1:] == idx[:, :-1]] = 0
    nz = np.nonzero(query_bow)[0]
    L = max(per_row, len(nz))
    rows_idx = np.zeros((K, L), np.int64)
    rows_val = np.zeros((K, L), np.float32)
    rows_idx[:, :per_row], rows_val[:, :per_row] = idx, val
    plain = np.ones(K, bool)
    for r, keep in DETECT_TWINS:
        rows_idx[r], rows_val[r] = 0, 0
        if keep is None:
            sel, v = nz, query_bow[nz]
            plain[r] = False
        else:
            sel = nz[rng.rand(len(nz)) < keep]
            v = query_bow[sel] * (0.5 + rng.rand(len(sel))).astype(
                np.float32)
        rows_idx[r, :len(sel)], rows_val[r, :len(sel)] = sel, v
    norm = rows_val.sum(1, keepdims=True, dtype=np.float32)
    rows_val[plain] /= norm[plain]
    covis = np.zeros((K, K), np.int32)
    pairs = [(g[i], g[i + 1], 40 - 10 * i) for g in DETECT_GROUPS
             for i in range(len(g) - 1)] + [(100, 3, 60)]
    for a, b, w in pairs:
        covis[a, b] = covis[b, a] = w
    return rows_idx, rows_val, covis


# the BoW scoring kernel's shapes: the drive's (KITTI's 2048 keyframes at
# 10^6 words, 159-186 live at the window's end) and the desk's (TUM's 512
# keyframes at 10^4 words, 12-42 live), each also with every row live
BOW_DRIVE_LIVE, BOW_DESK_SHAPE, BOW_DESK_LIVE = 186, (512, 10_000), 42


def bow_rows_ms(fn, flush, reps: int = 10) -> float:
    """Median device ms of one call with the L2 cache flushed before it (a
    128 MB write, which also keeps the card busy while the host enqueues
    the call): the table rows come from device memory, as after a
    keyframe's insertion."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def check_bow_kernel(bow_cuda, vocab_mod, drive_table, drive_q):
    """`place.vocab.table_scores` on the card (csrc/bow_score.cu) against
    its plain version at the drive's shape (phase 28's seeded 2048 x 10^6
    table, the first BOW_DRIVE_LIVE rows listed, then all) and the desk's
    (a seeded 512 x 10^4 table, BOW_DESK_LIVE rows, then all): the same
    shared-word counts, scores within DETECT_SCORE_ATOL, two calls
    bit-identical, one call counted on the device a call; the device ms
    of a call (L2 flushed) against its bound, the listed rows and the
    query read once, and the plain version's ms.  Returns the rows."""
    g = torch.Generator(device="cuda").manual_seed(WIDE_SEED)
    K, W = BOW_DESK_SHAPE
    desk = torch.rand(K, W, device="cuda", generator=g) * (
        torch.rand(K, W, device="cuda", generator=g) < 0.03)
    desk /= desk.sum(1, keepdim=True)
    desk_q = 0.5 * desk[7] + 0.5 * desk[30]
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    out = []
    for name, table, q, live in (
            ("drive", drive_table, drive_q, BOW_DRIVE_LIVE),
            ("drive, all live", drive_table, drive_q, drive_table.shape[0]),
            ("desk", desk, desk_q, BOW_DESK_LIVE),
            ("desk, all live", desk, desk_q, desk.shape[0])):
        K, W = table.shape
        ar = torch.arange(K, device="cuda")
        rows = torch.where(ar < live, ar, -1)
        calls = bow_cuda.device_counts()
        s, c = vocab_mod.table_scores(q, table, rows)
        s2, c2 = vocab_mod.table_scores(q, table, rows)
        torch.cuda.synchronize()
        counted = tuple(b - a for a, b in zip(calls,
                                              bow_cuda.device_counts()))
        ps, pc = vocab_mod.table_scores_plain(q, table, rows)
        err = float((s - ps).abs().max())
        same = torch.equal(s, s2) and torch.equal(c, c2)
        k_ms = bow_rows_ms(lambda: vocab_mod.table_scores(q, table, rows),
                           flush)
        p_ms = time_ms(lambda: vocab_mod.table_scores_plain(q, table, rows),
                       reps=5, warm=1)
        bound_ms = (live + 1) * W * 4 / PEAK_BYTES_PER_S * 1e3
        print(f"bow_score {name} ({K} x {W}, {live} rows listed): "
              f"{k_ms:.4f} ms device (L2 flushed), bound {bound_ms:.4f} ms "
              f"(bytes: {(live + 1) * W * 4 / 1e9:.4f} GB), "
              f"{100 * bound_ms / k_ms:.1f}% of it; plain {p_ms:.3f} ms; "
              f"counts {'equal' if torch.equal(c, pc) else 'DIFFER'}, "
              f"scores max abs err {err:.2e}; two calls "
              f"{'bit-identical' if same else 'DIFFER'}; counted {counted}",
              flush=True)
        check(torch.equal(c, pc), f"bow_score {name}: shared-word counts "
              "differ from the plain version's")
        check(err <= DETECT_SCORE_ATOL, f"bow_score {name}: scores {err} "
              "from the plain version's")
        check(same, f"bow_score {name}: two calls differ")
        check(counted == (2, 2 * live), f"bow_score {name}: the device "
              f"counted {counted} for 2 calls of {live} rows")
        out.append(dict(name=name, K=K, W=W, live=live, ms=k_ms,
                        bound_ms=bound_ms, plain_ms=p_ms, err=err))
    del desk, flush
    return out


def phase_vocab_kitti(SLAM, config, settings, datasets, system, vocab_mod,
                      database, bow_cuda, counters, root, yaml, kref, paths,
                      vocabs):
    """Phase 28: the KITTI 00-02 preset (`kitti_config`'s capacity: 2048
    keyframes, so a 2048 x 10^6 kf_bow) with the wide tree, and with the
    default vocabulary beside it, through the session API over phase 12's
    directory and settings: phase 12's captured-program checks, every
    keyframe's BoW row equal to the CPU transform's, the trajectory
    bit-identical to phase 12's run `kref` where nothing fired; peak
    memory, the device ms of a keyframe frame and of a plain frame.  Then
    detection over a seeded 2048 x 10^6 table with planted twins in three
    chunks of rows (`detection_table`): a candidate from each, the ids
    equal to a float64 numpy reference's (`detect_reference`) and the
    scores within DETECT_SCORE_ATOL of its (float32 sums of a row's
    ~10^3 non-zero terms), its device ms and its peak memory above the
    table; every scoring call of the detection through the kernel, counted
    on the device (also in the sessions).  Last, `check_bow_kernel` on that
    table and on one of the desk's shape.  Returns ({path: launches}, the
    numbers)."""
    Timed = timed_session(SLAM)
    items = datasets.load_kitti_stereo(root)
    launches, out = {}, {}
    for depth, vpath in ((4, system.DEFAULT_VOCAB), (6, paths[6])):
        name = f"KITTI at 10^{depth} words"
        cfg = settings.load_settings(yaml, config.STEREO).replace(
            vocab=config.VocabConfig(depth=depth))
        check(cfg.cap.max_keyframes == 2048, "the KITTI settings' capacity")
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _zero(counters)
        bow_cuda.reset_device_counts()
        t0 = time.perf_counter()
        slam = Timed(cfg, device="cuda", vocab_path=vpath)
        for left, right, t in datasets.SequenceReader(items, "stereo"):
            slam.track_stereo(left, right, t)
        slam.flush()
        wall = time.perf_counter() - t0
        launches[f"kitti_1e{depth}"] = _read(counters)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        _check_program(name, slam, launches[f"kitti_1e{depth}"],
                       counters[0].device_counts()[1])
        bow_bytes = slam.state.kf_bow.numel() * 4
        rows, worst = check_bow_rows(name, slam, vocab_mod.build_transform(
            vocabs.get(depth) or vocab_mod.Vocabulary.load(vpath),
            pad_to=10 ** depth, device="cpu"))
        ins, plain = frame_spans(slam, system.n_stages(cfg))
        fired = slam.reloc_attempts > 0 or slam.last_loop_kf >= 0
        differ = _same_run(slam, kref)
        scored = bow_cuda.device_counts()
        print(f"{name} via the session ({len(items)} frames): {wall:.2f} "
              f"s, keyframes {int(slam.state.n_kf)}, kf_bow "
              f"{bow_bytes / 1e9:.3f} GB, peak {peak:.3f} GiB above the "
              f"process's {base_mem / 2 ** 30:.3f}; {span_text(ins, plain)}; "
              f"{rows} BoW rows equal the CPU transform's (max "
              f"err {worst:.2e}); launches {launches[f'kitti_1e{depth}']}; "
              f"BoW scoring calls / rows {scored}; "
              f"{'bit-identical to phase 12' if differ is None else 'differs from phase 12: ' + differ}",
              flush=True)
        check(fired or differ is None, f"{name}: nothing fired, yet the "
              f"run differs from phase 12's in {differ}")
        check(scored[0] > 0, f"{name}: no detection scored through the "
              "kernel")
        out[10 ** depth] = dict(
            keyframes=int(slam.state.n_kf), kf_bow_bytes=bow_bytes,
            peak_gib=peak, keyframe_frame_ms=ins,
            plain_frame_ms=statistics.median(plain),
            bow_rows=rows, bow_score_calls=scored[0])
        if depth == 6:
            # the query: the transform of the last keyframe's descriptors
            k = int(slam.state.kf_valid.nonzero()[-1, 0])
            q = slam._transform(slam.state.kf_desc[k],
                                slam.state.kf_kp_valid[k])[0]
        del slam
    torch.cuda.empty_cache()
    qh = q.cpu().numpy()
    rows_idx, rows_val, covis = detection_table(qh)
    K = len(rows_idx)
    table = torch.zeros((K, q.shape[0]), device="cuda")
    table.scatter_add_(1, torch.as_tensor(rows_idx, device="cuda"),
                       torch.as_tensor(rows_val, device="cuda"))
    valid = torch.ones(K, dtype=torch.bool, device="cuda")
    covis_d = torch.as_tensor(covis, device="cuda")
    min_score = torch.tensor(0.01, device="cuda")
    detect = lambda: database.detect_loop_candidates(
        table, valid, covis_d, 100, q, min_score)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    table_mem = torch.cuda.memory_allocated()
    calls = bow_cuda.device_counts()
    res = detect()
    torch.cuda.synchronize()
    # one scoring call over the rows that are not the query or connected
    # to it: all but 100 and 3
    check(tuple(b - a for a, b in zip(calls, bow_cuda.device_counts())) ==
          (1, K - 2), "detection at 10^6 words: not one kernel call over "
          "the table's other rows")
    det_peak = (torch.cuda.max_memory_allocated() - table_mem) / 2 ** 30
    det_ms = queued_ms(detect, reps=10)
    # the least time: the table read once
    det_bound = table.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    ids = res.ids.cpu().numpy()
    scores = res.scores.cpu().numpy().astype(np.float64)
    want, want_scores = detect_reference(
        rows_idx, rows_val.astype(np.float64), qh.astype(np.float64),
        np.ones(K, bool), covis, 100, 0.01)
    found = ids >= 0
    score_err = float(np.abs(scores[found] - want_scores[found]).max())
    print(f"detection over {K} x {q.shape[0]} (kf_bow "
          f"{table.numel() * 4 / 1e9:.3f} GB): {det_ms:.3f} ms (the table "
          f"read once: {det_bound:.3f} ms), peak {det_peak:.3f} GiB above "
          f"the table; ids {ids.tolist()} scores "
          f"{[round(float(x), 6) for x in scores]} (float64 reference ids "
          f"{want.tolist()}, scores max abs err {score_err:.2e})",
          flush=True)
    check(17 in ids.tolist(), "detection at 10^6 words: the planted twin "
          "was not retrieved")
    # one candidate from each group, two of them from later rows
    check(sorted(set(ids[found] // 1000)) == [0, 1, 2], "detection at 10^6 "
          "words: not one candidate from each planted group")
    check(np.array_equal(ids, want), "detection at 10^6 words: ids differ "
          "from the float64 reference")
    check(score_err <= DETECT_SCORE_ATOL, "detection at 10^6 words: scores "
          f"{score_err} from the float64 reference's")
    out["bow_score"] = check_bow_kernel(bow_cuda, vocab_mod, table, q)
    del table
    out["detect"] = dict(ms=det_ms, bound_ms=det_bound, peak_gib=det_peak,
                         ids=ids.tolist())
    return launches, out


def phase_place(seq, mono_ref, kref, kroot, yaml, paths):
    """Phases 26-28, in phase 25's process: spawned after the kernels'
    timings and running no torch.profiler trace, so that the captured
    frames' device spans (`timed_session`) read the device (after a trace
    CUPTI stays attached to a process and a graph launch blocks its host).
    `seq`: the mono bench sequence; `mono_ref` / `kref`: phase 5's and
    phase 12's runs (`run_record`); `kroot`, `yaml`: phase 12's directory
    and settings; `paths`: phase 25's npz files.  The kernels load from
    the builds of phase 2.  Returns ({path: launches}, the numbers)."""
    from orb_slam2_tpu_torch import config, cuda_build
    from orb_slam2_tpu_torch.core import control
    from orb_slam2_tpu_torch.frontend import fast_cuda
    from orb_slam2_tpu_torch.io import datasets, evaluate, settings, synthetic
    from orb_slam2_tpu_torch.pipeline import system
    from orb_slam2_tpu_torch.pipeline.system import SLAM
    from orb_slam2_tpu_torch.place import bow_cuda, database
    from orb_slam2_tpu_torch.place import vocab as vocab_mod
    from orb_slam2_tpu_torch.solvers import pose_lm_cuda, pose_opt
    for build in (fast_cuda.build, pose_lm_cuda.build, bow_cuda.build,
                  lambda: cuda_build.build(control.SOURCE)):
        build()
    counters = (fast_cuda, pose_lm_cuda, pose_opt)
    vocabs = {d: vocab_mod.Vocabulary.load(p) for d, p in paths.items()}
    launches, mono = phase_vocab_mono(SLAM, config, system, vocab_mod, seq,
                                      evaluate, counters, paths, vocabs,
                                      mono_ref)
    loop = phase_vocab_scenarios(SLAM, config, synthetic, evaluate,
                                 counters, paths)
    kl, kitti = phase_vocab_kitti(SLAM, config, settings, datasets, system,
                                  vocab_mod, database, bow_cuda, counters,
                                  kroot, yaml, kref, paths, vocabs)
    launches.update(kl)
    return launches, dict(mono=mono, loop=loop, kitti=kitti)


def phase_batch(SLAM, cfg, seq, counters):
    """Phase 15: the bench mono sequence's first BATCH_FRAMES frames with
    frame_batch = BATCH against frame_batch = 1: bit-identical trajectory
    logs up to the first host reaction that changed the state."""
    runs = {}
    for fb in (1, BATCH):
        slam = SLAM(cfg.replace(frame_batch=fb), device="cuda")
        events = []
        reset, merge, check_reloc, check_loops = slam.reset, \
            slam._gba.merge, slam._check_reloc, slam._check_loops

        def on_reset(slam=slam, reset=reset, events=events):
            events.append((slam.frame_count, "reset"))
            reset()

        def on_merge(*a, slam=slam, merge=merge, events=events):
            events.append((slam.frame_count, "global BA merged"))
            return merge(*a)

        def on_reloc(force=False, slam=slam, events=events,
                     check_reloc=check_reloc):
            pending = slam._reloc_pending
            check_reloc(force)
            if pending is not None and slam._reloc_pending is None and \
                    slam.status == 2:
                events.append((slam.frame_count, "relocalised"))

        def on_loops(force=False, slam=slam, events=events,
                     check_loops=check_loops):
            kf = slam.last_loop_kf
            check_loops(force)
            if slam.last_loop_kf != kf:
                events.append((slam.frame_count, "loop corrected"))

        slam.reset, slam._gba.merge, slam._check_reloc, slam._check_loops = \
            on_reset, on_merge, on_reloc, on_loops
        _zero(counters)
        run_slam(SLAM, cfg, seq, BATCH_FRAMES, slam=slam)
        runs[fb] = (slam, events, _read(counters))
    (a, ev_a, launches), (b, ev_b, _) = runs[BATCH], runs[1]
    ta = a.ts.traj[:BATCH_FRAMES].cpu().numpy()
    tb = b.ts.traj[:BATCH_FRAMES].cpu().numpy()
    differ = np.nonzero((ta != tb).any(1))[0]
    first = int(differ[0]) if len(differ) else None
    events = sorted(set(ev_a + ev_b))
    print(f"frame batching: {BATCH_FRAMES} mono frames with frame_batch = "
          f"{BATCH} and 1: trajectory logs "
          + ("bit-identical" if first is None else
             f"first differ at frame {first}")
          + f"; host reactions {events or 'none'}; tracked "
          f"{int((ta[:, 15] > 0.5).sum())} / {int((tb[:, 15] > 0.5).sum())};"
          f" batched run launches {launches}", flush=True)
    if first is not None:
        check(any(f <= first + a.hud_lag for f, _ in events),
              f"frame batching: runs differ at frame {first} with no host "
              "reaction before it")
    check(int((ta[:, 15] > 0.5).sum()) >= TRACKED_MIN_FRAC * BATCH_FRAMES,
          "frame batching: the batched run lost track")
    _check_launched("frame batching", launches, BATCH_FRAMES)
    return launches


def phase_perlevel(counters, images, extractor, pyramid, fast_cuda,
                   build_atlas_extractor):
    """Phase 16: the per-level extractor at full width on each (name, ORB
    config, image); returns (launches, FAST rows for the kernels line)."""
    rows, launched = [], 0
    for name, ocfg, img in images:
        H, W = img.shape
        x = torch.as_tensor(img, device="cuda")
        L = ocfg.n_levels
        # every level through the single-image kernel vs its plain version
        levels = pyramid.build_pyramid(x, L, ocfg.scale_factor)
        err, exact = 0.0, True
        for lv in levels:
            kn, kr = fast_cuda.fast_nms_raw(lv)
            pn, pr = fast_cuda.fast_nms_raw_plain(lv)
            err = max(err, float((kn - pn).abs().max()),
                      float((kr - pr).abs().max()))
            exact &= bool(torch.equal(kn, pn)) and bool(torch.equal(kr, pr))
        check(exact, f"per-level {name}: single-image FAST disagrees with "
              f"its plain version (max_abs_err {err})")
        ext = extractor.build_extractor_perlevel(ocfg, H, W)
        ext_plain = extractor.build_extractor_perlevel(ocfg, H, W, "cuda",
                                                       use_kernel=False)
        # the path: counts zeroed just before, read just after
        _zero(counters)
        fk = ext(x)
        torch.cuda.synchronize()
        n = _read(counters)["fast_nms"]
        launched += n
        fp = ext_plain(x)
        check(n == L, f"per-level {name}: {n} FAST launches, not {L}")
        same = {f: bool(torch.equal(a, b))
                for f, a, b in zip(fk._fields, fk, fp)}
        check(all(same.values()),
              f"per-level {name}: kernel run differs from the plain one: "
              f"{same}")
        atlas = build_atlas_extractor(ocfg, H, W, "cuda")
        fa = atlas(x)
        va, vp = fa.valid, fk.valid
        d = (fa.uv[va][:, None, :] - fk.uv[vp][None, :, :]).abs().amax(-1)
        hit = ((d <= 1.0) & (fa.octave[va][:, None] ==
                             fk.octave[vp][None, :])).any(1)
        share = float(hit.float().mean())
        per_ms = time_ms(lambda: ext(x), reps=10)
        atlas_ms = time_ms(lambda: atlas(x), reps=10)
        plain_ms = time_ms(lambda: ext_plain(x), reps=5, warm=1)
        call = lambda: [fast_cuda.fast_nms_raw(lv) for lv in levels]
        # the trace can drop launches: the mean of those it recorded
        d_one = device_ms(call, "fast_nms_atlas_kernel")
        d_ms = None if d_one is None else d_one * L
        q_ms = queued_ms(call)
        px = [lv.shape[0] * lv.shape[1] for lv in levels]
        b_s = sum(p * (FAST_IN_BYTES_PER_PX + FAST_OUT_BYTES_PER_PLANE_PX)
                  for p in px) / PEAK_BYTES_PER_S
        o_s = sum(px) * FAST_OPS_PER_PX / PEAK_F32_OPS_PER_S
        bound_ms = max(b_s, o_s) * 1e3
        rows.append(dict(name=name, err=err, device_ms=d_ms,
                         queued_ms=q_ms, bound_ms=bound_ms,
                         bound_by="bytes" if b_s >= o_s else "operations",
                         per_ms=per_ms, atlas_ms=atlas_ms))
        print(f"per-level extractor {name} ({L} levels, "
              f"{int(vp.sum())} keypoints): {n} FAST launches, single-image "
              f"FAST bit-exact on every level, Features equal to the plain "
              f"run on the card ({', '.join(same)}); extraction "
              f"{per_ms:.4f} ms per-level (plain FAST {plain_ms:.4f}) vs "
              f"atlas {atlas_ms:.4f} ms; the {L} single-plane launches on "
              f"the device {_dev(d_ms)} in all ({L} x the mean launch the "
              f"trace recorded; queued back to back {q_ms:.5f} ms) vs "
              f"bound {bound_ms:.5f} ms "
              f"({rows[-1]['bound_by']}); atlas "
              f"keypoints with a per-level one at the same octave within "
              f"1 px: {share:.4f} of {int(va.sum())}", flush=True)
    return dict(fast_nms=launched, pose_lm=0), rows


def _glyph_pixels_match(px, raster, text: str, x0: int, baseline: int):
    """Whether the black pixels of `px` in the glyph box of `text` at
    (x0, baseline) are exactly the glyphs' ink (font scale 1)."""
    bm = raster.glyphs(text)
    h, w = bm.shape
    box = px[baseline - h + 1:baseline + 1, x0:x0 + w]
    return box.shape[:2] == bm.shape and bool(
        np.array_equal((box == 0).all(-1), bm))


def phase_viz(SLAM, cfg, seq, counters, port_cli, tmp):
    """Phase 17: an AR session over the bench mono sequence's first
    AR_FRAMES frames on the card, then every renderer on its state."""
    from orb_slam2_tpu_torch.core import camera
    from orb_slam2_tpu_torch.io.png import read_png
    from orb_slam2_tpu_torch.viz import ar, raster, viewer
    slam = SLAM(cfg)                      # no device named: the card
    session = ar.ARSession(slam)
    _zero(counters)
    t0 = time.perf_counter()
    for f in range(AR_FRAMES):
        session.step(seq.images[f], seq.timestamps[f])
    slam.flush()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    check(slam.device.type == "cuda", "AR session not on the card")
    check(slam.status == 2, f"AR session: status {slam.status}")
    _check_launched("AR session", launches, AR_FRAMES)
    H, W = seq.images[0].shape
    lime = np.array([0, 255, 0], np.uint8)

    ms = {}
    t0 = time.perf_counter()
    path = slam.draw_current_frame(os.path.join(tmp, "frame.png"))
    ms["draw_current_frame"] = (time.perf_counter() - t0) * 1e3
    px = read_png(path)
    check(px.shape == (H + 26, W, 3),
          f"draw_current_frame: PNG of shape {px.shape}")
    uv, valid = slam.get_tracked_keypoints_un()
    pids = slam.get_tracked_map_points()
    tracked = valid & (pids >= 0)
    n = int(tracked.sum())
    check(n > 50, f"draw_current_frame: {n} tracked keypoints")
    bad = [(x, y) for x, y in np.floor(uv[tracked]).astype(int)
           if not (px[y - 3 if y >= 3 else y + 3, x] == lime).all()]
    check(not bad, f"draw_current_frame: no tracked colour at {bad[:5]}")
    status = (f"SLAM MODE | KFs: {int(slam.state.n_kf)}, MPs: "
              f"{int(slam.state.n_mp)}, Matches: {n}")
    check(_glyph_pixels_match(px, raster, status, 4, H + 16),
          f"draw_current_frame: the status bar does not read {status!r}")

    t0 = time.perf_counter()
    out = viewer.render_map(slam.state, os.path.join(tmp, "map.png"),
                            traj=slam.poses_twc())
    ms["render_map"] = (time.perf_counter() - t0) * 1e3
    mp = read_png(out)
    check(mp.shape == (1170, 1430, 3), f"render_map: PNG of {mp.shape}")
    n_kf_px = int((mp == (0x1f, 0x77, 0xb4)).all(-1).sum())
    n_traj_px = int((mp == (0xff, 0x7f, 0x0e)).all(-1).sum())
    check(n_kf_px > 0 and n_traj_px > 0,
          f"render_map: keyframe pixels {n_kf_px}, trajectory {n_traj_px}")

    map_path = os.path.join(tmp, "ar_map.npz")
    traj_path = os.path.join(tmp, "ar_traj.txt")
    slam.save_map(map_path)
    slam.save_trajectory_tum(traj_path)
    t0 = time.perf_counter()
    out = port_cli.main(["view", "--map", map_path, "--traj", traj_path,
                         "--out", os.path.join(tmp, "view.png")])
    ms["cli view"] = (time.perf_counter() - t0) * 1e3
    check(out is not None and read_png(out).shape == (1170, 1430, 3),
          "cli view did not write the map PNG")

    img = seq.images[AR_FRAMES - 1]
    Tcw = slam.ts.T.cpu().numpy()
    K4 = camera.intrinsics(cfg.camera).numpy()
    t0 = time.perf_counter()
    out = ar.render_ar(img, Tcw, K4, session.plane,
                       os.path.join(tmp, "ar.png"), status="SLAM")
    ms["render_ar"] = (time.perf_counter() - t0) * 1e3
    apx = read_png(out)
    check(apx.shape == (H, W, 3), f"render_ar: PNG of {apx.shape}")
    plane_s = "no plane found"
    if session.plane is not None:
        sc = ar.ar_scene(img, Tcw, K4, session.plane, status="SLAM")
        mids = [np.floor(ln.pts.mean(0)).astype(int) for ln in sc.lines]
        inside = [(x, y) for x, y in mids if 0 <= x < W and 0 <= y < H - 20]
        plane_s = (f"plane normal {np.round(session.plane.n, 4).tolist()} "
                   f"origin {np.round(session.plane.o, 4).tolist()}, cube "
                   f"edges {len(sc.lines)}, {len(inside)} midpoints in the "
                   "frame")
        check(sc.lines and inside and all(
            (apx[y, x] == lime).all() for x, y in inside),
            f"render_ar: the cube's edges were not drawn ({plane_s})")
    print(f"viewer/AR on the card's session: {AR_FRAMES} frames through "
          f"ARSession.step in {wall:.2f} s, status {slam.status}, "
          f"keyframes {int(slam.state.n_kf)}, points {int(slam.state.n_mp)}, "
          f"{n} tracked keypoints drawn; {plane_s}; status bar "
          f"{status!r}; render ms (host) "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; launches {launches}", flush=True)
    return launches


def _count_calls(module, name, log):
    """Wrap `module.name` so that each call appends its name to `log`;
    returns the original."""
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        log.append(name)
        return inner(*args, **kwargs)

    setattr(module, name, counted)
    return inner


def _dp_run(dp, tracking, frame_profile, cfg, seqs, seeds, counters,
            capture, profiled=False):
    """init + DP_FRAMES - 1 steps of the dp program (`DPProgram`) over the
    sequences `seeds`, captured or eager: steps 1 to DP_WARM - 1 (the
    captured program's first step captures it), then the window from
    step DP_WARM to the end, timed (`frame_profile.time_steps`) or, with
    `profiled`, each step under a torch.profiler trace of its own (device
    activity; short traces): device ms and kernels a step, each kernel's
    device ms a launch.  The captured run's steps run under
    set_sync_debug_mode("error"): after `init`, only the capture's warm-up
    and the window's ends may synchronise.  Returns a dict of the run.

    The earlier phases' torch.profiler traces leave CUPTI attached to the
    process, and then each graph launch blocks the host until the graph
    has nearly run: the captured times here are the program's in that
    state.  `dp_profile.py` times it in a fresh process (tearing CUPTI
    down instead, TEARDOWN_CUPTI=1, makes the later traces lose events)."""
    from torch.profiler import ProfilerActivity, profile
    S = len(seeds)
    imgs, depths, stamps = _dp_inputs(seqs, seeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    _zero_track(tracking)
    prog = dp.DPProgram(cfg, S, "cuda", capture=capture)
    prog.init(imgs[:, 0], depths[:, 0])
    guard = _no_sync if capture else contextlib.nullcontext
    step = lambda f: prog.step(imgs[:, f], depths[:, f], f, stamps[:, f])
    with guard():
        for f in range(1, DP_WARM):
            step(f)
    n = DP_FRAMES - DP_WARM
    out = dict(prog=prog)
    if profiled:
        dev_us = n_kernels = 0
        per = {"fast_nms": ["fast_nms_atlas_kernel", 0.0, 0],
               "pose_lm": ["pose_lm_kernel", 0.0, 0]}
        before = _read(counters)
        for f in range(DP_WARM, DP_FRAMES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                with guard():
                    step(f)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = frame_profile.device_time_us(e)
                dev_us += us
                n_kernels += e.count
                for acc in per.values():
                    if acc[0] in e.key:
                        acc[1] += us
                        acc[2] += e.count
        ran = {k: v - before[k] for k, v in _read(counters).items()}
        # a kernel's device ms a launch only where the traces recorded
        # every launch the device counted in the window (a replay of a
        # large graph drops some)
        out.update(dev_ms=dev_us / 1e3 / n, kernels=n_kernels / n,
                   per_launch={k: a[1] / 1e3 / a[2] if a[2] == ran[k]
                               else None for k, a in per.items()},
                   traced={k: (a[2], ran[k]) for k, a in per.items()})
    else:
        out.update(frame_profile.time_steps(step, range(DP_WARM, DP_FRAMES),
                                            guard))
    torch.cuda.synchronize()
    out.update(state=prog.state, ts=prog.ts, huds=prog.huds(),
               launches=_read(counters),
               planes=counters[0].device_counts()[1],
               capture_s=prog.capture_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **_read_track(tracking))
    return out


def _dp_inputs(seqs, seeds):
    """Images, depth maps [S, F, H, W] and timestamps [S, F] of the
    sequences `seeds`, on the card."""
    stack = lambda k: torch.as_tensor(np.stack(
        [np.asarray(getattr(seqs[s], k), np.float32) for s in seeds])).cuda()
    return stack("images"), stack("depths"), stack("timestamps")


# the track step's device counts: reference-keyframe fallbacks (one a
# sequence), and the steps that ran the motion model and the reference-
# keyframe match (one batched call for all sequences each)
_TRACK_COUNTS = {"fallbacks": "ref_kf_fallbacks",
                 "motion_steps": "motion_model_steps",
                 "ref_steps": "ref_kf_steps",
                 "need_close": "need_close_frames"}


# the batched insertion's and each stage group's calls (`system.
# insert_calls`, `system.stage_calls`: one a call whatever S), device-counted
_STAGE_KEYS = ("insert", "triangulate", "fuse", "local_ba", "cull")


def _stage_counters():
    from orb_slam2_tpu_torch.pipeline import system
    return dict(insert=system.insert_calls, **system.stage_calls)


def _zero_track(tracking):
    for name in _TRACK_COUNTS.values():
        getattr(tracking, name).reset()
    for c in _stage_counters().values():
        c.reset()


def _read_track(tracking):
    out = {k: int(getattr(tracking, name))
           for k, name in _TRACK_COUNTS.items()}
    out["calls"] = {k: int(c) for k, c in _stage_counters().items()}
    return out


def _dp_split(dp, dp_profile, tracking, cfg, seqs, S, counters):
    """The eager program over the first S sequences, each step of the
    window profiled and its device time and kernels charged by phase
    (`dp_profile.split_run`: extract, track, insert, stage, other); with
    its state, HUDs and device counts."""
    _zero(counters)
    _zero_track(tracking)
    r = dp_profile.split_run(dp, cfg, *_dp_inputs(seqs, range(S)), DP_WARM)
    torch.cuda.synchronize()
    prog = r.pop("prog")
    r.update(state=prog.state, ts=prog.ts, huds=prog.huds(),
             launches=_read(counters), **_read_track(tracking))
    return r


def _dp_track_batch(dp, tracking, pose_lm_cuda, cfg, seqs, S, at):
    """One batched track call over S sequences against S single-sequence
    calls, on the inputs the eager dp program's track took at step `at`
    (recorded), and on a mixed batch made from them (sequence 1 without a
    velocity: the reference keyframe; sequence 2 with a velocity that
    turns the camera round: its motion model fails, the fallback): states,
    track states, point ids and HUDs bit-identical, the same
    per-sequence counts, and one pose-LM launch for each batched solve."""
    clone = lambda t: type(t)(*(x.clone() for x in t))
    rec, calls = [], [0]
    build = tracking.build_track_step

    def recording(c):
        track = build(c)

        def wrapped(state, ts, frame, *args, **kwargs):
            calls[0] += 1
            if calls[0] == at:
                rec.append(tuple(clone(x) for x in (state, ts, frame)))
            return track(state, ts, frame, *args, **kwargs)
        return wrapped

    imgs, depths, stamps = _dp_inputs(seqs, range(S))
    tracking.build_track_step = recording
    try:
        prog = dp.DPProgram(cfg, S, "cuda", capture=False)
        prog.init(imgs[:, 0], depths[:, 0])
        for f in range(1, at + 1):
            prog.step(imgs[:, f], depths[:, f], f, stamps[:, f])
    finally:
        tracking.build_track_step = build
    del prog
    state, ts, frame = rec[0]
    track = build(cfg)
    vel, has = ts.velocity.clone(), ts.has_velocity.clone()
    vel[2].zero_()
    vel[2, 2].fill_(1.0)
    has[1].fill_(False)
    one = lambda t, s: type(t)(*(x[s:s + 1] for x in t))
    for name, tt in (("recorded", ts),
                     ("mixed", ts._replace(velocity=vel, has_velocity=has))):
        _zero_track(tracking)
        l0 = pose_lm_cuda.device_launches()
        many = track(state, tt, frame)
        l_many = pose_lm_cuda.device_launches() - l0
        c_many = _read_track(tracking)
        _zero_track(tracking)
        l0 = pose_lm_cuda.device_launches()
        ones = [track(one(state, s), one(tt, s), one(frame, s))
                for s in range(S)]
        l_ones = pose_lm_cuda.device_launches() - l0
        c_ones = _read_track(tracking)
        differ = []
        for s in range(S):
            for part, a, b in zip(("state", "ts", "cur_pids", "hud"), many,
                                  ones[s]):
                pairs = zip(a._fields, a, b) if isinstance(a, tuple) else \
                    [("", a, b)]
                differ += [f"{s}:{part}.{f}" for f, x, y in pairs
                           if not torch.equal(x[s], y[0])]
        print(f"dp track over S={S}, the inputs of step {at} ({name}; has "
              f"velocity {tt.has_velocity.tolist()}): one batched call "
              f"against {S} single calls: fields differing "
              f"{differ or 'none'}; statuses "
              f"{many[3][:, 0].tolist()}; pose-LM launches {l_many} against "
              f"{l_ones}; counts batched {c_many}, single {c_ones}",
              flush=True)
        check(not differ, f"dp: the batched track differs from the single "
              f"calls ({name}: {differ[:8]})")
        check(all(c_many[k] == c_ones[k] for k in ("fallbacks",
                                                  "need_close")),
              f"dp: per-sequence counts of the batched track {c_many} "
              f"against the single calls' {c_ones} ({name})")
        check(l_many == 1 + c_many["motion_steps"] + c_many["ref_steps"],
              f"dp: {l_many} pose-LM launches for one batched track call "
              f"({name}, counts {c_many})")
        if name == "mixed":
            check(c_many["fallbacks"] >= 1 and c_many["motion_steps"] == 1
                  and c_many["ref_steps"] == 1,
                  f"dp: the mixed batch took no fallback ({c_many})")


def _read_track_of(r):
    return {k: r[k] for k in tuple(_TRACK_COUNTS) + ("calls",)}


def _dp_ate(dp, evaluate, seqs, seeds, run):
    """Per sequence of a dp run: (tracked frames, metric ATE)."""
    out = []
    for s, (t, twc) in zip(seeds, dp.trajectories(run["state"], run["ts"],
                                                  DP_FRAMES)):
        ie, ig = evaluate.match_timestamps(t, seqs[s].timestamps)
        out.append((len(ie), evaluate.ate_rmse(
            twc[ie], seqs[s].poses_twc[ig], align_scale=False)))
    return out


def _dp_against_alone(dp, tracking, frame_profile, cfg, seqs, big,
                      counters):
    """Each sequence of the S = DP_COMPARE run against its own S = 1 run
    (both captured): every state and track-state field, the trajectory
    and the HUDs bit-identical (every op of the batched step gives a
    sequence the bits of its S = 1 call: `core.seqwise`)."""
    for s in range(DP_COMPARE):
        alone = _dp_run(dp, tracking, frame_profile, cfg, seqs, [s],
                        counters, True)
        differ = [f"{k}.{f}" for k in ("state", "ts")
                  for f, x, y in zip(big[k]._fields, big[k], alone[k])
                  if not torch.equal(x[s], y[0])]
        same_hud = np.array_equal(big["huds"][:, s], alone["huds"][:, 0])
        kf_b = int(big["state"].kf_valid[s].sum())
        kf_a = int(alone["state"].kf_valid[0].sum())
        print(f"dp S={DP_COMPARE} sequence {s} against its S=1 run: fields "
              f"differing {differ or 'none'}, HUDs "
              f"{'equal' if same_hud else 'differ'}, keyframes {kf_b} / "
              f"{kf_a}", flush=True)
        check(not differ and same_hud,
              f"dp: sequence {s} of S={DP_COMPARE} differs from its S=1 run "
              f"({differ[:8]}, HUDs equal {same_hud})")
        del alone


def _dp_no_collective(dp, cfg, seqs):
    """The rank's step over its shard (`shard_batch`, `build_sharded_step`)
    on a 1-rank gloo group: no collective in two profiled steps, while an
    all-reduce of a CUDA tensor in the same kind of trace is counted."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_tpu_torch.distributed.launch import free_port
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        x = torch.ones(3, device="cuda")
        with profile(activities=acts) as prof:
            dist.all_reduce(x, group=g)
            torch.cuda.synchronize()
        seen = dp.collective_ops_in_trace(prof)
        check(seen >= 1 and bool((x == 1).all()),
              f"dp: an all-reduce of a CUDA tensor on a gloo group counted "
              f"{seen} collectives and gave {x.tolist()}")
        S = 2
        stack = lambda k: dp.shard_batch(torch.as_tensor(np.stack(
            [np.asarray(getattr(seqs[s], k)[:3], np.float32)
             for s in range(S)])).cuda(), g)
        imgs, depths, stamps = stack("images"), stack("depths"), \
            stack("timestamps")
        init_fn, step_fn = dp.build_sharded_step(cfg, g, "cuda")
        state, ts = dp.shard_batch(dp.make_batch_states(cfg, S, "cuda"), g)
        state, ts = init_fn(state, ts, imgs[:, 0], depths[:, 0])
        with profile(activities=acts) as prof:
            for f in (1, 2):
                fid = torch.full((S,), f, dtype=torch.int32, device="cuda")
                state, ts, _ = step_fn(state, ts, imgs[:, f], depths[:, f],
                                       fid, stamps[:, f])
            torch.cuda.synchronize()
        n_coll = dp.collective_ops_in_trace(prof)
    finally:
        dist.destroy_process_group()
    print(f"dp: build_sharded_step on a 1-rank gloo group, two profiled "
          f"steps of S={S}: {n_coll} collective events (an all-reduce of a "
          f"CUDA tensor in the same kind of trace: {seen})", flush=True)
    check(n_coll == 0, f"dp: the sharded step issued {n_coll} collectives")


def _dp_differ(a, b):
    """The state and track-state fields in which two dp runs differ."""
    return [f"{k}.{f}" for k in ("state", "ts")
            for f, x, y in zip(a[k]._fields, a[k], b[k])
            if not torch.equal(x, y)]


def _dp_line(S, tag, r, dev_ms, dev_src):
    """One run's times; `dev_ms`, the device ms a step over the same steps
    from the profiled run `dev_src` (captured and eager runs launch the
    same kernels: equal launch counts)."""
    q = statistics.quantiles(r["step_ms"], n=10)
    return (f"dp S={S} {tag}: step ms median "
            f"{statistics.median(r['step_ms']):.3f} p90 {q[8]:.3f} max "
            f"{max(r['step_ms']):.3f} (CUDA events, steps {DP_WARM}-"
            f"{DP_FRAMES - 1}), window wall {r['wall_ms']:.3f} ms a step "
            f"(host clock), host ms a step call median "
            f"{statistics.median(r['host_ms']):.3f}, total frames/s "
            f"{S * 1e3 / r['wall_ms']:.2f}, device {dev_ms:.3f} ms a step "
            f"({dev_src}), idle share {1 - dev_ms / r['wall_ms']:.3f}; peak "
            f"{r['peak_gib']:.3f} GiB; launches fast_nms "
            f"{r['launches']['fast_nms']} over {r['planes']} planes, pose_lm "
            f"{r['launches']['pose_lm']} (batched local-map, motion-model "
            f"and reference-keyframe solves; the last two ran in "
            f"{r['motion_steps']} and {r['ref_steps']} of {DP_FRAMES - 1} "
            f"steps), reference-keyframe fallbacks {r['fallbacks']}")


def phase_dp(dp, tracking, checkpoint, evaluate, fast_cuda, frame_profile,
             dp_profile, build_atlas_extractor, cfg, seqs, levels, counters,
             map_path):
    """Phase 18: S RGB-D sequences stepped together at full width, S in
    DP_SIZES, through the captured program and through the eager program
    on the same inputs (timed at DP_EAGER's sizes, and at every S profiled
    by phase).  Saves the S = 1 run's
    map (sequence 0) to `map_path`.  Returns (launches of each captured
    run, by path; FAST rows at 8·S planes; the kernels' device ms a
    launch under each captured run's replay)."""
    from orb_slam2_tpu_torch.map.state import MapState
    H, W = cfg.camera.height, cfg.camera.width
    # FAST on the S-image atlases of frame 0: bit-exact, timed, bounded
    atlases = []
    for S in (4, 8):
        img = torch.as_tensor(np.stack([seqs[s].images[0]
                                        for s in range(S)])).cuda()
        _, atlas = build_atlas_extractor(cfg.orb, H, W, "cuda", n_images=S,
                                         return_atlas=True)(img)
        atlases.append((f"dp S={S}, {8 * S} planes 640x480", levels, S,
                        atlas))
    fast_rows = check_fast(fast_cuda, atlases)
    check(all(r["exact"] for r in fast_rows),
          "dp: fast_nms disagrees with its plain version on an S-image atlas")
    for r in fast_rows:
        share = "not measured" if r["device_ms"] is None else \
            f"{r['bound_ms'] / r['device_ms']:.3f}"
        print(f"  dp FAST {r['name']}: the bound over the device time "
              f"{share}", flush=True)
    launches, fps, replay, stage_k = {}, {}, {}, {}
    steps = DP_FRAMES - 1
    for S in DP_SIZES:
        if S == max(DP_SIZES):
            torch.cuda.empty_cache()
        run = lambda capture, profiled=False: _dp_run(
            dp, tracking, frame_profile, cfg, seqs, list(range(S)), counters,
            capture, profiled)
        g = run(True)
        launches[f"dp_s{S}"] = g["launches"]
        # the same steps again, each profiled: device ms and kernels a
        # step, the kernels' device ms a launch under replay
        gp = run(True, True)
        differ = _dp_differ(g, gp)
        check(not differ and g["launches"] == gp["launches"],
              f"dp S={S}: two captured runs differ ({differ})")
        replay[S] = gp["per_launch"]
        # eagerly on the same inputs: timed where S is in DP_EAGER; at
        # every S profiled by phase (at the other S also the device ms: a
        # replay of that graph records only part of its kernels)
        sp = _dp_split(dp, dp_profile, tracking, cfg, seqs, S, counters)
        print(dp_profile.split_line(S, sp), flush=True)
        e = run(False) if S in DP_EAGER else sp
        dev_ms, dev_src = (gp["dev_ms"], "the captured run profiled") \
            if S in DP_EAGER else (sp["device_ms"], "the eager run "
                                   "profiled by phase, "
                                   f"{sp['kernels']:.1f} kernels a step")
        check(g["prog"].graph_replays == g["prog"].steps == steps,
              f"dp S={S}: {g['prog'].graph_replays} graph replays for "
              f"{g['prog'].steps} steps")
        check(g["launches"]["fast_nms"] == DP_FRAMES and
              g["planes"] == 8 * S * DP_FRAMES,
              f"dp S={S}: {g['launches']['fast_nms']} FAST launches over "
              f"{g['planes']} planes, not one over {8 * S} a step")
        # one batched local-map solve a step, and one motion-model and one
        # reference-keyframe solve in the steps where some sequence took
        # them (device-counted): 2 a step plus the steps that took the
        # reference keyframe beside the motion model, whatever S is
        both = g["motion_steps"] + g["ref_steps"] - steps
        check(g["launches"]["pose_lm"] == steps + g["motion_steps"] +
              g["ref_steps"] and 0 <= both <= steps,
              f"dp S={S}: pose_lm launches {g['launches']['pose_lm']}, not "
              f"{steps} steps + {g['motion_steps']} motion-model + "
              f"{g['ref_steps']} reference-keyframe batches "
              "(device-counted)")
        print(f"dp S={S}: pose_lm launches {g['launches']['pose_lm']} = 2 x "
              f"{steps} steps + {both} steps that also took the reference "
              f"keyframe ({g['fallbacks']} fallbacks over {S} sequences)",
              flush=True)
        # the insertion and each stage group: one batched call in a step at
        # most, whatever S (device-counted)
        calls = g["calls"]
        check(all(0 <= calls[k] <= steps for k in _STAGE_KEYS) and
              calls["insert"] > 0 and calls["local_ba"] > 0,
              f"dp S={S}: insertion / stage-group calls {calls} for {steps} "
              "steps")
        stage_k[S] = sum(sp["phases"][k]["kernels"]
                         for k in ("insert", "stage"))
        print(f"dp S={S}: batched calls over {steps} steps (device-counted): "
              + ", ".join(f"{k} {calls[k]}" for k in _STAGE_KEYS) +
              f"; insert + stage kernels a step {stage_k[S]:.1f} (x"
              f"{stage_k[S] / stage_k[min(stage_k)]:.3f} of S="
              f"{min(stage_k)})", flush=True)
        res = _dp_ate(dp, evaluate, seqs, range(S), g)
        for s, (n, ate) in enumerate(res):
            check(n >= DEPTH_TRACKED_MIN_FRAC * DP_FRAMES and
                  ate <= DEPTH_ATE_GATE_M["rgbd"],
                  f"dp S={S} sequence {s}: tracked {n}/{DP_FRAMES}, metric "
                  f"ATE {ate} m")
        fps[S] = S * 1e3 / g["wall_ms"]
        print(f"dp S={S}: total frames/s {fps[S]:.2f} (x"
              f"{fps[S] / fps[min(DP_SIZES)]:.3f} of S=1; captured); tracked "
              f"{[n for n, _ in res]} of {DP_FRAMES}, metric ATE "
              f"{[round(a, 6) for _, a in res]} m, keyframes "
              f"{[int(v) for v in g['state'].kf_valid.sum(1)]}; "
              f"{g['prog'].graph_replays} graph replays for "
              f"{g['prog'].steps} steps, capture {g['capture_s']:.3f} s; "
              f"kernels a step {gp['kernels']:.1f}; under replay FAST "
              f"{_dev(replay[S]['fast_nms'])} and pose LM "
              f"{_dev(replay[S]['pose_lm'])} a launch (device; launches "
              f"traced of counted {gp['traced']}; the profiled run "
              "bit-identical to the timed one)", flush=True)
        print(_dp_line(S, "captured", g, dev_ms, dev_src), flush=True)
        if S in DP_EAGER:
            print(_dp_line(S, "eager", e, dev_ms, dev_src), flush=True)
        eagers = [("eager", e)] + ([] if e is sp else [("eager by phase",
                                                        sp)])
        for tag, r in eagers:
            differ = _dp_differ(g, r)
            same_hud = np.array_equal(g["huds"], r["huds"])
            print(f"dp S={S}: captured against {tag}: state fields differing "
                  f"{differ or 'none'}, HUDs "
                  f"{'equal' if same_hud else 'differ'}", flush=True)
            check(not differ and same_hud,
                  f"dp S={S}: captured and {tag} runs differ ({differ}, HUDs "
                  f"equal {same_hud})")
            check(g["launches"] == r["launches"] and
                  _read_track_of(g) == _read_track_of(r),
                  f"dp S={S}: device launch counts {g['launches']} captured, "
                  f"{r['launches']} {tag}")
        del e, sp
        if S == 1:
            checkpoint.save_map(MapState(*(x[0] for x in g["state"])),
                                map_path)
        if S == DP_COMPARE:
            _dp_against_alone(dp, tracking, frame_profile, cfg, seqs, g,
                              counters)
            _dp_track_batch(dp, tracking, counters[1], cfg, seqs, S,
                            DP_WARM)
        if S == max(DP_SIZES):
            print(f"dp S={S}: peak device memory {g['peak_gib']:.3f} GiB "
                  f"(captured), capture {g['capture_s']:.3f} s (warm-up "
                  "of every branch and capture)", flush=True)
        del g, gp
    _dp_no_collective(dp, cfg, seqs)
    return launches, fast_rows, replay


def _centers(lie, T):
    T = torch.as_tensor(T)
    return (-lie.quat_rotate(lie.quat_conj(T[:, :4]), T[:, 4:7])).numpy()


def _pose_err(lie, evaluate, a, b):
    """tests/test_ba.py's `_pose_err(align_scale=False)`: max camera-centre
    distance after a rigid alignment."""
    ca, cb = _centers(lie, a), _centers(lie, b)
    s, R, t = evaluate.umeyama(ca, cb, False)
    return float(np.linalg.norm((s * (R @ ca.T)).T + t - cb, axis=-1).max())


def phase_sharded(launch, evaluate, cfg, map_path: str, tmp: str):
    """Phase 19: `distributed/launch.py` spawns SHARD_RANKS gloo ranks on
    the one card (CUDA tensors; SLAM_* set, `init_multihost` joins them);
    each sharded solver, twice, against the single-rank solver here."""
    from orb_slam2_tpu_torch import convert
    from orb_slam2_tpu_torch.ba import local as ba_local
    from orb_slam2_tpu_torch.ba import posegraph, schur
    from orb_slam2_tpu_torch.core import lie
    from orb_slam2_tpu_torch.map import checkpoint
    obs, _, _ = launch.make_ba_problem(n_cams=64, n_pts=4096, noise_px=0.4,
                                       pose_noise=0.02, pt_noise=0.02,
                                       seed=11)
    ring, _ = launch.make_ring_problem(n=48, drift=0.015, seed=2)
    D = cfg.cap.max_obs_per_point
    jobs = [dict(name="obs", kind="obs", problem=obs, **SHARD_BA_ITERS),
            dict(name="pt", kind="pt", map=map_path, cfg=cfg, D=D,
                 **SHARD_BA_ITERS),
            dict(name="pg", kind="pg", problem=ring, **SHARD_PG_ITERS)]
    t0 = time.time()
    try:
        launch.spawn(launch.solve_worker, SHARD_RANKS,
                     (jobs, tmp, "cuda", "gloo", 2, True),
                     timeout=SHARD_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        raise PhaseError(f"sharded solvers: {e}") from e
    wall = time.time() - t0
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(SHARD_RANKS)]
    for r, rank in enumerate(ranks):
        marks = ", ".join(f"{k} +{v - t0:.1f} s" for k, v in zip(
            ["started", "joined"] + [j["name"] for j in jobs],
            rank["timeline"]))
        print(f"  rank {r}: {marks}", flush=True)
    singles = {
        "obs": convert.ba_problem_from_numpy(obs, "cuda"),
        "pt": ba_local.build_global_problem_point_major(
            checkpoint.load_map(map_path, "cuda"), cfg),
        "pg": convert.pose_graph_problem_from_numpy(ring, "cuda")}
    print(f"sharded solvers: {SHARD_RANKS} gloo ranks on the card, CUDA "
          f"tensors, spawned and joined in {wall:.1f} s", flush=True)
    for job in jobs:
        name = job["name"]
        prob = singles[name]
        outs, ms = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "pg":
                nodes, _ = posegraph.optimize_pose_graph(prob,
                                                         **SHARD_PG_ITERS)
                outs.append({"nodes": nodes.cpu().numpy()})
            else:
                res = schur.ba_solve(prob, **SHARD_BA_ITERS)
                outs.append({k: v.cpu().numpy()
                             for k, v in res._asdict().items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        r0 = ranks[0]
        keys = [k for k in r0 if k.startswith(name + ".") and
                k.endswith(".0")]
        for k in keys:
            for r in ranks:
                check(np.array_equal(r[k], r[k[:-1] + "1"]),
                      f"sharded {name}: {k} differs between two runs")
                check(np.array_equal(r[k], r0[k]),
                      f"sharded {name}: {k} differs between the ranks")
        for k in outs[0]:
            check(np.array_equal(outs[0][k], outs[1][k]),
                  f"single-rank {name}: {k} differs between two runs")
        pose_tol, point_tol = SHARD_TOL[name]
        if name == "pg":
            err = float(np.linalg.norm(r0["pg.nodes.0"] - outs[0]["nodes"],
                                       axis=-1).max())
            check(err < pose_tol, f"sharded pose graph: nodes {err} from "
                  "the single-rank solve")
            detail = f"nodes max |d| {err:.3g}"
        else:
            perr = _pose_err(lie, evaluate, r0[f"{name}.cam_pose.0"],
                             outs[0]["cam_pose"])
            n = outs[0]["points"].shape[0]
            pts = float(np.abs(r0[f"{name}.points.0"][:n] -
                               outs[0]["points"]).max())
            same_in = np.array_equal(
                r0[f"{name}.inlier.0"][:outs[0]["inlier"].shape[0]],
                outs[0]["inlier"])
            check(perr < pose_tol and pts <= point_tol and same_in,
                  f"sharded {name} BA: poses {perr}, points {pts}, inlier "
                  f"masks equal {same_in}")
            detail = (f"poses {perr:.3g}, points {pts:.3g}, inlier masks "
                      "equal")
        coll = r0[f"{name}.allreduce_ms"]
        print(f"  {name}: sharded {statistics.median(r0[name + '.ms']):.1f}"
              f" ms (rank 0, median of 2), single-rank "
              f"{statistics.median(ms):.1f} ms; {len(coll)} all-reduces, "
              f"{coll.sum():.1f} ms of them timed alone; against the "
              f"single-rank solve {detail} (tolerance {pose_tol}"
              f"{'' if point_tol is None else f' / {point_tol}'}); "
              "bit-equal on repeat and across ranks", flush=True)


# phase 20: the cells run captured and eager, and the windows of frames
# timed (host clock, one synchronisation at each end) and profiled
# (torch.profiler), each ONE_PROG_WINDOW frames, after the first 20
ONE_PROG_WINDOW = 20
ONE_PROG_ATE_TOL_M = 1e-6


def _feed_one(slam, seq, right, f):
    if slam.cfg.sensor == 1:
        slam.track_stereo(seq.images[f], right[f], seq.timestamps[f])
    elif slam.cfg.sensor == 2:
        slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])
    else:
        slam.track_mono(seq.images[f], seq.timestamps[f])


@contextlib.contextmanager
def _no_sync():
    """set_sync_debug_mode("error") inside: a synchronisation raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _one_program_run(SLAM, cfg, seq, right, capture, counters, frame_profile):
    """One run of a phase 20 cell; returns the session and its numbers.
    The captured run feeds every frame under set_sync_debug_mode("error"):
    a synchronisation outside the session's host reactions raises.  The
    eager run checks that each pose_optimize call was one kernel launch."""
    n = len(seq.images)
    w0, w1, w2 = 20, 20 + ONE_PROG_WINDOW, 20 + 2 * ONE_PROG_WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    slam = SLAM(cfg, device="cuda", capture=capture)
    track = lambda f: _feed_one(slam, seq, right, f)
    guard = _no_sync if capture else contextlib.nullcontext
    pose_opt, calls = counters[2], []
    inner = None if capture else _count_calls(pose_opt, "pose_optimize",
                                              calls)
    try:
        with guard():
            for f in range(w0):
                track(f)
        wall_ms = frame_profile.wall_window(track, range(w0, w1), guard)
        dev_ms, n_kernels, _, _ = frame_profile.profile_window(
            track, range(w1, w2), guard)
        with guard():
            for f in range(w2, n):
                track(f)
    finally:
        if inner is not None:
            pose_opt.pose_optimize = inner
    slam.flush()
    launches = _read(counters)
    if not capture:
        check(launches["pose_lm"] == len(calls),
              f"eager run: {launches['pose_lm']} pose LM launches for "
              f"{len(calls)} pose_optimize calls")
    times = [t * 1e3 for t in slam.timings[10:]]
    qs = statistics.quantiles(times, n=10)
    dev_ms /= ONE_PROG_WINDOW
    return slam, dict(
        launches=launches, p50=statistics.median(times), p90=qs[8],
        max=max(times), wall_ms=wall_ms, device_ms=dev_ms,
        idle=1.0 - dev_ms / wall_ms, kernels=n_kernels / ONE_PROG_WINDOW,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        replays=slam.graph_replays, dispatches=slam._n_dispatch)


def phase_one_program(SLAM, cfg, st_cfg, rgbd_cfg, seq, st_seq, right,
                      evaluate, counters, frame_profile):
    """Phase 20: each cell through the captured program and the eager
    step on the same inputs."""
    cells = [("mono", cfg, seq, None), ("stereo", st_cfg, st_seq, right),
             ("rgbd", rgbd_cfg, st_seq, None),
             (f"mono frame_batch {BATCH}", cfg.replace(frame_batch=BATCH),
              seq, None)]
    out = {}
    for name, c, sq, rt in cells:
        g, gn = _one_program_run(SLAM, c, sq, rt, True, counters,
                                 frame_profile)
        e, en = _one_program_run(SLAM, c, sq, rt, False, counters,
                                 frame_profile)
        differ = [f"{st}.{f}" for st, a, b in
                  (("state", g.state, e.state), ("ts", g.ts, e.ts))
                  for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
        ate_g = ate_of(g, sq, evaluate, align_scale=c.sensor == 0)
        ate_e = ate_of(e, sq, evaluate, align_scale=c.sensor == 0)
        pg, pe = g.poses_twc(), e.poses_twc()
        same_traj = pg.shape == pe.shape and (pg == pe).all()
        B = c.frame_batch
        stepped = len(sq.images) - int(e.state.kf_frame_id[
            1 if c.sensor == 0 else 0]) - 1
        print(f"one program, {name}: {len(sq.images)} frames; captured: "
              f"{gn['replays']} graph launches for {gn['dispatches']} "
              f"dispatches (frame_batch {B}), frame ms p50 {gn['p50']:.2f} "
              f"p90 {gn['p90']:.2f} max {gn['max']:.2f}, window wall "
              f"{gn['wall_ms']:.3f} ms a frame, device {gn['device_ms']:.3f} "
              f"ms a frame, idle {gn['idle']:.3f}, kernels a frame "
              f"{gn['kernels']:.1f}, peak {gn['peak_gib']:.3f} GiB, "
              f"launches {gn['launches']}; eager: frame ms p50 "
              f"{en['p50']:.2f} p90 {en['p90']:.2f} max {en['max']:.2f}, "
              f"window wall {en['wall_ms']:.3f} ms a frame, device "
              f"{en['device_ms']:.3f} ms a frame, idle {en['idle']:.3f}, "
              f"kernels a frame {en['kernels']:.1f}, peak "
              f"{en['peak_gib']:.3f} GiB, launches {en['launches']}; "
              f"trajectories {'bit-identical' if same_traj else 'differ'}, "
              f"state fields differing {differ or 'none'}; ATE "
              f"{ate_g[0]:.6f} / {ate_e[0]:.6f} m", flush=True)
        check(gn["replays"] == gn["dispatches"] > 0,
              f"{name}: {gn['replays']} graph launches for "
              f"{gn['dispatches']} dispatches")
        check(gn["dispatches"] == -(-g.frames_stepped // B),
              f"{name}: {gn['dispatches']} graph launches for "
              f"{g.frames_stepped} frames stepped {B} a program")
        check(gn["launches"] == en["launches"],
              f"{name}: device launch counts {gn['launches']} captured, "
              f"{en['launches']} eager")
        check(gn["launches"]["fast_nms"] == len(sq.images),
              f"{name}: {gn['launches']['fast_nms']} FAST launches for "
              f"{len(sq.images)} frames")
        check(gn["launches"]["pose_lm"] >= 2 * stepped,
              f"{name}: {gn['launches']['pose_lm']} pose LMs for {stepped} "
              "stepped frames")
        check(same_traj and not differ or
              abs(ate_g[0] - ate_e[0]) <= ONE_PROG_ATE_TOL_M,
              f"{name}: captured and eager runs differ ({differ}) beyond "
              f"{ONE_PROG_ATE_TOL_M} m of ATE")
        out[name] = dict(captured=gn, eager=en, identical=same_traj and
                         not differ)
        del g, e
    return out


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    try:
        from orb_slam2_tpu_torch import cli as port_cli
        from orb_slam2_tpu_torch import (config, cuda_build, dp_profile,
                                         frame_profile, native_build)
        from orb_slam2_tpu_torch.core import control
        from orb_slam2_tpu_torch.frontend import (extractor, fast_cuda,
                                                  pyramid)
        from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
        from orb_slam2_tpu_torch.io import datasets, evaluate, synthetic
        from orb_slam2_tpu_torch.distributed import dp, launch
        from orb_slam2_tpu_torch.map import checkpoint
        from orb_slam2_tpu_torch.pipeline import mapping, tracking
        from orb_slam2_tpu_torch.pipeline.system import SLAM
        from orb_slam2_tpu_torch.place import bow_cuda
        from orb_slam2_tpu_torch.solvers import pose_lm_cuda, pose_opt
    except ImportError as e:
        return fail(f"the orb_slam2_tpu_torch package is missing ({e}); run "
                    "from the repository root")
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.abspath(config.__file__))
    if os.path.dirname(pkg) != here:
        return fail(f"orb_slam2_tpu_torch found at {pkg}, not beside this "
                    "script")
    if "jax" in sys.modules:
        return fail("jax was imported")
    global DP_SIZES, DP_FRAMES, DP_WARM
    DP_SIZES, DP_FRAMES, DP_WARM = (dp_profile.SIZES, dp_profile.FRAMES,
                                    dp_profile.WARM)

    # 1. environment
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    counters = (fast_cuda, pose_lm_cuda, pose_opt)
    # the sequences render on the host while the kernels build: the bench's
    # mono sequence, and its stereo one (bench.py `_run_stereo`) with the
    # right eye from `right_poses`
    cfg = config.SLAMConfig()
    cam = cfg.camera
    st_cfg = config.SLAMConfig(sensor=config.STEREO,
                               camera=config.CameraConfig(bf=40.0))
    rgbd_cfg = st_cfg.replace(sensor=config.RGBD)
    kitti_cam = config.kitti_config().camera
    render = ThreadPoolExecutor(4)
    seq_f = render.submit(synthetic.generate, cam, n_frames=N_FRAMES,
                          n_points=500, trajectory="xyz", seed=0)
    st_seq_f = render.submit(synthetic.generate, st_cfg.camera,
                             n_frames=STEREO_FRAMES, n_points=500,
                             trajectory="xyz", seed=0)
    right_f = render.submit(
        synthetic.generate, st_cfg.camera, n_frames=STEREO_FRAMES,
        n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(
            synthetic.xyz_trajectory(STEREO_FRAMES), st_cfg.camera.baseline))
    kitti_f = render.submit(kitti_sequence, synthetic, kitti_cam)
    render.shutdown(wait=False)
    # phases 21 and 23-24's scenes and phase 18's sequences, in two
    # processes of their own (the scenes first: their phases run first)
    dp_render = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    lens_f = dp_render.submit(lens_sequence, config.tum1_config().camera)
    euroc_f = [dp_render.submit(euroc_eye, side)
               for side in ("LEFT", "RIGHT")]
    dp_f = [dp_render.submit(synthetic.generate, rgbd_cfg.camera,
                             n_frames=DP_FRAMES, n_points=500,
                             trajectory="xyz", seed=s)
            for s in range(max(DP_SIZES))]
    dp_render.shutdown(wait=False)
    vocab_dir = tempfile.mkdtemp(dir=here, prefix="_smoke_")
    place_job = None
    try:
        # 2. build every kernel at once (one nvcc each): FAST, the pose LM
        # as the source has it, the BoW scores, and the pose LM at each
        # cluster size
        t0 = time.perf_counter()
        jobs = [lambda: fast_cuda.build(verbose=True),
                lambda: pose_lm_cuda.build(verbose=True),
                lambda: bow_cuda.build(verbose=True),
                lambda: cuda_build.build(control.SOURCE),
                lambda: native_build.build("png_unfilter")] + [
            (lambda c=c: pose_lm_cuda.build(cluster=c)) for c in CLUSTERS]
        with ThreadPoolExecutor(len(jobs)) as ex:
            libs = list(ex.map(lambda job: job(), jobs))
        print(f"build: {libs} in {time.perf_counter() - t0:.2f} s",
              flush=True)

        # 3. FAST kernel vs plain version, on the main path's atlas, the
        # small configuration's, a two-image one, and the two-image atlas
        # the stereo path builds from its first frame pair
        level_shapes = lambda h, w: pyramid.level_shapes(
            h, w, cfg.orb.n_levels, cfg.orb.scale_factor)
        main_levels = level_shapes(cam.height, cam.width)
        t0 = time.perf_counter()
        seq, st_seq, right = seq_f.result(), st_seq_f.result(), \
            right_f.result().images
        print(f"sequences rendered ({time.perf_counter() - t0:.1f} s waited "
              "after the build)", flush=True)
        pair = torch.stack([torch.as_tensor(st_seq.images[0]),
                            torch.as_tensor(right[0])])
        ext2_gpu = build_atlas_extractor(st_cfg.orb, cam.height, cam.width,
                                         "cuda", n_images=2,
                                         return_atlas=True)
        ext2_cpu = build_atlas_extractor(st_cfg.orb, cam.height, cam.width,
                                         "cpu", n_images=2,
                                         return_atlas=True)
        f2g, pair_atlas = ext2_gpu(pair.cuda())
        rows = check_fast(fast_cuda, [
            ("main path 640x480", main_levels, 1, None),
            ("small configuration 320x240", level_shapes(240, 320), 1, None),
            ("two 640x480 images", main_levels, 2, None),
            ("stereo pair 640x480", main_levels, 2, pair_atlas)])
        check(all(r["exact"] for r in rows),
              "fast_nms kernel disagrees with its plain version")
        frame_row = rows[0]
        f2c, pair_atlas_cpu = ext2_cpu(pair)
        agree = []
        for b in range(2):
            same = ((f2g.valid[b].cpu() == f2c.valid[b]) &
                    (f2g.octave[b].cpu() == f2c.octave[b]) &
                    ((f2g.uv[b].cpu() - f2c.uv[b]).abs().amax(-1) <= 1e-3))
            agree.append(float(same.float().mean()))
        atlas_err = float((pair_atlas.cpu() - pair_atlas_cpu).abs().max())
        print(f"two-image extractor card vs CPU on the stereo pair: "
              f"{agree[0]:.4f} / {agree[1]:.4f} of 2 x {f2c.valid.shape[1]} "
              f"slots agree (left / right), atlas max_abs_err {atlas_err}",
              flush=True)
        check(min(agree) >= 0.99 and atlas_err <= 1e-3,
              "two-image extractor on the card disagrees with the CPU run")
        print(f"fast_nms, one frame's 8 levels in one launch: call "
              f"{frame_row['ms']:.4f} ms, kernel on the device "
              f"{_dev(frame_row['device_ms'])} (queued "
              f"{frame_row['queued_ms']:.5f} ms), bound "
              f"{frame_row['bound_ms']:.5f} ms ({frame_row['bound_by']}); "
              f"second slice, 8 launches: calls {SECOND_SLICE_FAST[1]} ms, "
              f"kernels on the device {SECOND_SLICE_FAST[0]} ms", flush=True)
        ext_gpu = build_atlas_extractor(cfg.orb, cam.height, cam.width,
                                        "cuda")
        ext_cpu = build_atlas_extractor(cfg.orb, cam.height, cam.width, "cpu")
        img0 = torch.as_tensor(seq.images[0])
        fg, fc = ext_gpu(img0.cuda()), ext_cpu(img0)
        same = ((fg.valid.cpu() == fc.valid) & (fg.octave.cpu() == fc.octave)
                & ((fg.uv.cpu() - fc.uv).abs().amax(-1) <= 1e-3))
        print(f"extractor card vs CPU: {float(same.float().mean()):.4f} of "
              f"{same.numel()} slots agree", flush=True)
        check(float(same.float().mean()) >= 0.99,
              "extractor on the card disagrees with the CPU run")

        # 4. pose-LM kernel vs plain version, then each cluster size
        pose_rows = check_pose_lm(pose_lm_cuda, pose_opt, config.BAConfig)
        main_row = pose_rows[0]      # the shape tracking gives it: B=1, N=1024
        print(f"pose_lm N=1024 mono: call {main_row['ms']:.4f} ms, kernel on "
              f"the device {_dev(main_row['device_ms'])} (queued "
              f"{main_row['queued_ms']:.5f} ms; cluster of "
              f"{pose_lm_cuda.load().cluster} blocks); second slice, one "
              f"block: call {SECOND_SLICE_POSE[1]} ms, kernel on the device "
              f"{SECOND_SLICE_POSE[0]} ms",
              flush=True)
        sweep_clusters(pose_lm_cuda, pose_opt, config.BAConfig,
                       {c: pose_lm_cuda.load(c) for c in CLUSTERS})

        # 25. the ORBvoc text and its parses, in a process of its own that
        # starts after the kernels' timings; the same process runs phases
        # 26-28 after phase 24, where no torch.profiler trace has run
        place_job = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        text_f = place_job.submit(phase_vocab_text, vocab_dir)

        # 5. main path, vocabulary on
        mono_slam, launches = phase_path("main path", SLAM, cfg, seq,
                                         evaluate, counters, TRACKED_MIN_FRAC,
                                         ATE_GATE_M)
        launches, mono_ref = {"mono": launches}, run_record(mono_slam)
        del mono_slam

        # 6. relocalisation, 7. loop closing
        phase_reloc(SLAM, cfg, synthetic, counters)
        loop_first = phase_loop(SLAM, e2e_small_cfg(config), synthetic,
                                evaluate)

        # 8. determinism
        a = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
        b = run_slam(SLAM, cfg, seq, DET_FRAMES).poses_twc()
        check(a.shape == b.shape and (a == b).all(),
              "two identical runs gave different trajectories")
        print(f"determinism: two {DET_FRAMES}-frame runs bit-identical "
              f"({a.shape[0]} poses)", flush=True)
        a = run_slam(SLAM, st_cfg, st_seq, DET_FRAMES, right=right
                     ).poses_twc()
        b = run_slam(SLAM, st_cfg, st_seq, DET_FRAMES, right=right
                     ).poses_twc()
        check(a.shape == b.shape and (a == b).all(),
              "two identical stereo runs gave different trajectories")
        print(f"determinism: two {DET_FRAMES}-frame stereo runs "
              f"bit-identical ({a.shape[0]} poses)", flush=True)

        # 9. stereo main path, 10. RGB-D main path
        _, launches["stereo"], st_problem = phase_depth_path(
            "stereo main path", SLAM, st_cfg, st_seq, right, evaluate,
            counters, mapping, pose_opt)
        _, launches["rgbd"], _ = phase_depth_path(
            "rgbd main path", SLAM, rgbd_cfg, st_seq, None, evaluate,
            counters, mapping, pose_opt)

        # 11-15: the session API (PNG, settings, checkpoints in a
        # temporary directory)
        with tempfile.TemporaryDirectory(dir=here, prefix="_smoke_") as tmp:
            launches["mono_loc"] = phase_mono_loc(SLAM, cfg, seq, evaluate,
                                                  counters, tmp)
            t0 = time.perf_counter()
            kseq, kright = kitti_f.result()
            print(f"KITTI sequence rendered ({time.perf_counter() - t0:.1f} s "
                  "waited)", flush=True)
            kslam, kroot, launches["kitti_cli"], kitti_problem = phase_kitti(
                port_cli, mapping, tracking, pose_opt, evaluate, counters,
                kseq, kright, tmp)
            launches["kitti_loc"] = phase_kitti_loc(
                SLAM, datasets, tracking, counters, kslam, kroot, evaluate,
                kseq, tmp)
            kref = run_record(kslam)
            del kslam
            launches["tum_cli"] = phase_tum(port_cli, evaluate, counters,
                                            st_seq, rgbd_cfg.camera, tmp)

            # 21-24: the example paths no phase above drives
            ex = (port_cli, mapping, tracking, evaluate, counters, tmp)
            t0 = time.perf_counter()
            lseq = lens_f.result()
            eseq, eright = euroc_f[0].result(), euroc_f[1].result()
            print(f"lens and EuRoC scenes rendered "
                  f"({time.perf_counter() - t0:.1f} s waited)", flush=True)
            launches["tum_mono_cli"], _ = phase_example(
                "TUM mono with the fr1 lens via the CLI", "tum_mono_cli",
                *ex, lseq, "tum", "mono", os.path.join(tmp, "tum_fr1"),
                tum_settings(config.tum1_config().camera), JAX_TUM_MONO,
                write=lambda root: write_tum_mono_dir(root, lseq))
            del lseq
            launches["kitti_mono_cli"], _ = phase_example(
                "KITTI mono via the CLI", "kitti_mono_cli", *ex, kseq,
                "kitti", "mono", kroot, KITTI_SETTINGS, JAX_KITTI_MONO)
            eroot = os.path.join(tmp, "euroc_mav")
            launches["euroc_stereo_cli"], euroc_problem = phase_example(
                "EuRoC stereo via the CLI", "euroc_stereo_cli", *ex, eseq,
                "euroc", "stereo", eroot, EUROC_STEREO_SETTINGS,
                JAX_EUROC_STEREO, write=lambda root: write_euroc_dir(
                    root, eseq, eright), record=True, need_close=True)
            launches["euroc_mono_cli"], _ = phase_example(
                "EuRoC mono via the CLI", "euroc_mono_cli", *ex, eseq,
                "euroc", "mono", eroot, EUROC_MONO_SETTINGS, JAX_EUROC_MONO)
            # the first frame pair as the stereo reader rectifies it
            epair = next(iter(datasets.SequenceReader(
                datasets.load_euroc_stereo(eroot)[:1], "stereo",
                rectify=datasets.euroc_rectify_maps(
                    os.path.join(tmp, "euroc_stereo_cli.yaml")))))[:2]
            del eseq, eright

            # 26-28: place recognition at the reference vocabulary's
            # width, in phase 25's process
            t0 = time.perf_counter()
            vpaths, text_nums = text_f.result()
            print(f"(phase 25: {time.perf_counter() - t0:.1f} s waited)",
                  flush=True)
            torch.cuda.empty_cache()
            place_launches, place = place_job.submit(
                phase_place, seq, mono_ref, kref, kroot,
                os.path.join(tmp, "kitti.yaml"), vpaths).result()
            launches.update(place_launches)
        launches["batch"] = phase_batch(SLAM, cfg, seq, counters)

        # 16. the per-level extractor at full width
        launches["perlevel"], perlevel_rows = phase_perlevel(
            counters, [("bench mono 640x480", cfg.orb, seq.images[0]),
                       ("KITTI 00-02 left 1241x376",
                        config.kitti_config().orb, kseq.images[0])],
            extractor, pyramid, fast_cuda, build_atlas_extractor)

        # 17. viewer, AR and the view command on the card's session
        with tempfile.TemporaryDirectory(dir=here, prefix="_smoke_") as tmp:
            launches["ar"] = phase_viz(SLAM, cfg, seq, counters, port_cli,
                                       tmp)

        # 3 (continued). FAST on the KITTI stereo pair's real atlas
        kpair = torch.stack([torch.as_tensor(kseq.images[0]),
                             torch.as_tensor(kright[0])]).cuda()
        _, kitti_atlas = build_atlas_extractor(
            config.kitti_config().orb, kitti_cam.height, kitti_cam.width,
            "cuda", n_images=2, return_atlas=True)(kpair)
        # and on the atlases of phase 22's first KITTI mono frame (as its
        # PNG reads back) and of phase 23's first rectified EuRoC pair
        euroc_orb = config.euroc_config().orb
        _, kmono_atlas = build_atlas_extractor(
            config.kitti_config().orb, kitti_cam.height, kitti_cam.width,
            "cuda", return_atlas=True)(torch.as_tensor(
                _u8(kseq.images[0]), dtype=torch.float32).cuda())
        _, euroc_atlas = build_atlas_extractor(
            euroc_orb, 480, 752, "cuda", n_images=2, return_atlas=True)(
            torch.stack([torch.as_tensor(x) for x in epair]).cuda())
        rows += check_fast(fast_cuda, [
            ("KITTI stereo pair 1241x376",
             level_shapes(kitti_cam.height, kitti_cam.width), 2, kitti_atlas),
            ("KITTI mono 1241x376",
             level_shapes(kitti_cam.height, kitti_cam.width), 1, kmono_atlas),
            ("EuRoC stereo pair 752x480", pyramid.level_shapes(
                480, 752, euroc_orb.n_levels, euroc_orb.scale_factor), 2,
             euroc_atlas)])
        check(all(r["exact"] for r in rows[-3:]),
              "fast_nms disagrees on the KITTI or EuRoC atlases")

        # 18. S RGB-D sequences stepped together, 19. the sharded solvers
        t0 = time.perf_counter()
        dp_seqs = [f.result() for f in dp_f]
        print(f"dp sequences rendered ({time.perf_counter() - t0:.1f} s "
              "waited)", flush=True)
        with tempfile.TemporaryDirectory(dir=here, prefix="_smoke_") as tmp:
            map_path = os.path.join(tmp, "dp_seq0_map.npz")
            dp_launches, dp_rows, dp_replay = phase_dp(
                dp, tracking, checkpoint, evaluate, fast_cuda, frame_profile,
                dp_profile, build_atlas_extractor, rgbd_cfg, dp_seqs,
                main_levels, counters, map_path)
            launches.update(dp_launches)
            rows += dp_rows
            del dp_seqs
            phase_sharded(launch, evaluate, rgbd_cfg, map_path, tmp)

        # 20. one program: captured against eager on each cell
        phase_one_program(SLAM, cfg, st_cfg, rgbd_cfg, seq, st_seq, right,
                          evaluate, counters, frame_profile)

        # 4 (continued). the pose LM on a problem of the stereo run and on
        # an N = 2048 one of the KITTI run
        pose_rows += check_pose_problems(pose_lm_cuda, pose_opt, [
            (name_, tuple(a[None] for a in prob[:7]) + tuple(prob[7:]))
            for name_, prob in (("stereo frame of phase 9", st_problem),
                                ("KITTI frame of phase 12, N = 2048",
                                 kitti_problem),
                                ("EuRoC stereo frame of phase 23",
                                 euroc_problem))])

        # 7 (again). the loop scenario at the end of the process
        phase_loop_again(SLAM, e2e_small_cfg(config), synthetic, evaluate,
                         loop_first)
    except PhaseError as e:
        return fail(str(e))
    finally:
        if place_job is not None:
            place_job.shutdown(cancel_futures=True)
        shutil.rmtree(vocab_dir, ignore_errors=True)

    total = {k: sum(v[k] for v in launches.values())
             for k in ("fast_nms", "pose_lm")}
    by_path = lambda k: {p: v[k] for p, v in launches.items()}

    kernels = [{
        "name": "fast_nms", "route": "cuda",
        "source": "orb_slam2_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orb_slam2_tpu/frontend/pallas_fast.py:42",
        # over every path driven (each counted from 0 just before its run),
        # and per path
        "launches": total["fast_nms"],
        "launches_by_path": by_path("fast_nms"),
        "max_abs_err": max(r["err"] for r in rows + perlevel_rows),
        # the per-level path: one frame's single-plane launches, summed
        "perlevel_device_ms": {r["name"]: r["device_ms"]
                               for r in perlevel_rows},
        "perlevel_bound_ms": {r["name"]: r["bound_ms"]
                              for r in perlevel_rows},
        # one frame: the main path's atlas of 8 levels, one launch
        "ms": frame_row["ms"],
        # the same launch replayed from a CUDA graph, as the session runs it
        "replay_ms": frame_row["replay_ms"],
        # device ms a launch inside the dp program's replay, by S (8·S
        # planes; null where the traces missed some of its launches)
        "dp_replay_device_ms": {S: r["fast_nms"]
                                for S, r in dp_replay.items()},
        "plain_ms": frame_row["plain_ms"],
        "bound_ms": frame_row["bound_ms"],
        "bound_by": frame_row["bound_by"],
        "library_ms": None,
        # each atlas of phase 3: device ms a launch and its bound
        "atlas_device_ms": {r["name"]: r["device_ms"] for r in rows},
        "atlas_bound_ms": {r["name"]: r["bound_ms"] for r in rows},
    }, {
        "name": "pose_lm", "route": "cuda",
        "source": "orb_slam2_tpu_torch/csrc/pose_lm.cu",
        "replaces": "scripts/study_pallas_pose.py:148",
        "launches": total["pose_lm"],
        "launches_by_path": by_path("pose_lm"),
        "max_abs_err": max(r["err"] for r in pose_rows),
        "ms": main_row["ms"],
        "replay_ms": main_row["replay_ms"],
        "dp_replay_device_ms": {S: r["pose_lm"]
                                for S, r in dp_replay.items()},
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        # no single PyTorch call computes a robust LM pose optimization
        "library_ms": None,
        # each problem of phase 4: device ms a launch and its bound
        "problem_device_ms": {r["name"]: r["device_ms"] for r in pose_rows},
        "problem_bound_ms": {r["name"]: r["bound_ms"] for r in pose_rows},
    }]
    print(json.dumps({"place_recognition": dict(text=text_nums, **place),
                      "card": card}))
    print(f"whole run: {time.perf_counter() - t_run:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
