"""The session API of the port against the JAX package, on the CPU, at
tests/test_e2e.py's small stereo configuration (320x240, 500 features,
bf = 16) with each package's default vocabulary on: localisation mode and
its VO points, map checkpoints, the frame-batched step, the trajectory
exports and the getters.

One JAX session with `frame_batch = 4` (its scanned super-step) runs
N_RUN frames and is flushed with a partial batch pending; its state is
carried into the port with `convert.py` where a test starts from it
(also for `draw_current_frame`, held against JAX's on its last image).
Stereo initialisation draws no random samples, so the two packages'
sessions part only by float round-off (sums in another order inside the
pose LMs and BAs) and are compared within stated tolerances.  The inputs
come from the JAX renderer (seed 0, xyz; the right eye from
`right_poses`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.io import synthetic
from orb_slam2_tpu.map import checkpoint as jcheckpoint
from orb_slam2_tpu.pipeline import tracking as jtracking
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.map import checkpoint as tcheckpoint
from orb_slam2_tpu_torch.map.state import resolve_replaced
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline import tracking as ttracking
from orb_slam2_tpu_torch.pipeline.tracking import LOST, NOT_INITIALIZED, OK
from test_torch_viz import recorded  # noqa: F401  (fixture)

STEREO = jconfig.STEREO
B = 4
# frame 0 initialises; frames 1-12 are three full batches; 13-14 a
# partial one that flush() pads
N_RUN = 15
# frames after N_RUN for the localisation and VO tests
N_SEQ = N_RUN + 4
# localisation on the saved map: these frames again
LOC = (3, 11)
# poses of the two packages' sessions: each frame's pose LMs sum ~400
# residuals in another order and the BAs feed that back, so frames drift
# apart by ~1e-5 m; 1e-3 leaves room and still fails on a lost frame or
# a different keyframe
POSE_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; the port's
    small tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(m, sensor=STEREO, **kw):
    """tests/test_e2e.py's small_cfg(sensor) for package config module m."""
    cam = m.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                         height=240, fps=30.0, bf=16.0, th_depth=35.0)
    return m.SLAMConfig(
        sensor=sensor, camera=cam,
        orb=m.ORBConfig(n_features=500, max_keypoints=512),
        cap=m.Capacity(max_keyframes=96, max_points=6144, max_obs_per_kf=512,
                       max_frames=512, local_ba_points=2048), **kw)


def close_cfg(m, **kw):
    """small_cfg with the close-depth threshold at 60 baselines (4.8 m), so
    that this room (depths 2-8 m) has close keypoints: at 35 (2.8 m)
    nearly none are, and VO points would not exist."""
    cfg = small_cfg(m, **kw)
    return cfg.replace(camera=dataclasses.replace(cfg.camera, th_depth=60.0))


def _fields(nt):
    return {f: np.array(v) for f, v in zip(nt._fields, nt)}


def _same_pose(a, b, atol):
    """Poses [..., 7] equal up to each quaternion's sign."""
    a, b = np.array(a, np.float64), np.asarray(b, np.float64)
    flip = np.sum(a[..., :4] * b[..., :4], -1) < 0
    a[..., :4] = np.where(flip[..., None], -a[..., :4], a[..., :4])
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _jaccard(a, b):
    a, b = set(np.asarray(a)[np.asarray(a) >= 0].tolist()), \
        set(np.asarray(b)[np.asarray(b) >= 0].tolist())
    return len(a & b) / max(len(a | b), 1)


@pytest.fixture(scope="module")
def seq():
    cam = small_cfg(jconfig).camera
    s = synthetic.generate(cam, n_frames=N_SEQ, n_points=300,
                           trajectory="xyz", seed=0)
    right = synthetic.generate(
        cam, n_frames=N_SEQ, n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(s.poses_twc,
                                             cam.baseline)).images
    return s, right


def _track(slam, seq, frames):
    s, right = seq
    for f in frames:
        slam.track_stereo(s.images[f], right[f], s.timestamps[f])


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX session with frame_batch = 4 over N_RUN frames, flushed (a
    partial batch of 2 padded): its state before each frame, its final
    state and exports.  JAX arrays are immutable: a reference is a copy."""
    slam = JSLAM(small_cfg(jconfig, frame_batch=B))
    assert slam._transform is not None and slam._super_step is not None
    snaps = []
    for f in range(N_RUN):
        snaps.append((slam.state, slam.ts))
        _track(slam, seq, [f])
    assert len(slam._batch) == 2
    slam.flush()
    return dict(slam=slam, snaps=snaps, state=slam.state, ts=slam.ts,
                poses=slam.poses_twc(), times=slam.timestamps(),
                frame_count=slam.frame_count)


def _port(cfg=None, **kw):
    return tsystem.SLAM(cfg or small_cfg(tconfig, **kw), device="cpu")


@pytest.fixture(scope="module")
def port_runs(seq):
    """The port over the same N_RUN frames with frame_batch 4 and 1."""
    out = {}
    for fb in (B, 1):
        slam = _port(frame_batch=fb)
        _track(slam, seq, range(N_RUN))
        if fb == B:
            assert len(slam._batch) == 2 and slam.frame_count == N_RUN
            out["before_flush_kf"] = int(slam.state.next_kf)
            out["before_flush_traj_ok"] = int((slam.ts.traj[:, 15] > 0.5
                                               ).sum())
        slam.flush()
        out[fb] = slam
    return out


def _carried(state, ts, device="cpu"):
    return (convert.map_state_from_numpy(_fields(state), device=device),
            convert.track_state_from_numpy(_fields(ts), device=device))


def _carried_session(jr, **kw):
    """A port session holding the JAX session's final state."""
    slam = _port(**kw)
    slam.state, slam.ts = _carried(jr["state"], jr["ts"])
    slam.frame_count, slam.status = jr["frame_count"], OK
    return slam


# ---------------------------------------------------------------------------
# the frame-batched step
# ---------------------------------------------------------------------------

def test_batched_run_matches_jax_super_step(jax_run, port_runs):
    """frame_batch = 4 in both packages over the same frames: every frame
    tracked in both, the same keyframes, poses within POSE_ATOL."""
    t = port_runs[B]
    assert t.poses_twc().shape == jax_run["poses"].shape == (N_RUN, 7)
    np.testing.assert_array_equal(t.timestamps(), jax_run["times"])
    _same_pose(t.poses_twc(), jax_run["poses"], POSE_ATOL)
    np.testing.assert_array_equal(t.state.kf_valid.numpy(),
                                  np.asarray(jax_run["state"].kf_valid))
    np.testing.assert_array_equal(t.state.kf_frame_id.numpy(),
                                  np.asarray(jax_run["state"].kf_frame_id))
    n_j = int(jax_run["state"].n_mp)
    assert abs(int(t.state.n_mp) - n_j) <= 0.02 * n_j + 2


def test_batched_run_equals_per_frame_run(port_runs):
    """On the CPU, frame_batch = 4 gives the per-frame run's state bit for
    bit: the per-frame arithmetic is the same, only the host reactions
    wait for the batch, and none changed the state here (no loss, no
    loop)."""
    a, b = port_runs[B], port_runs[1]
    for st_a, st_b in ((a.state, b.state), (a.ts, b.ts)):
        for f, x, y in zip(st_a._fields, st_a, st_b):
            assert torch.equal(x, y), f
    assert a.status == b.status == OK
    assert a.last_loop_kf == b.last_loop_kf == -100


def test_partial_batch_waits_for_flush(port_runs):
    """Before flush() the last 2 frames sit in the buffer (no pose logged,
    no keyframe made for them); flush() runs them as a batch of 2, unpadded
    (the JAX package pads it to 4 with inactive slots, which change
    nothing)."""
    a = port_runs[B]
    assert port_runs["before_flush_traj_ok"] == N_RUN - 2
    ok = a.ts.traj[:N_RUN, 15] > 0.5
    assert bool(ok.all())
    assert not a._batch


def test_reset_clears_the_batch(seq):
    slam = _port(frame_batch=B)
    _track(slam, seq, range(3))
    assert slam.status == OK and len(slam._batch) == 2
    slam.reset()
    assert not slam._batch and slam.status == NOT_INITIALIZED
    assert int(slam.state.next_kf) == 0


def test_batched_frames_push_their_huds_after_the_batch(seq):
    """The HUD entries of a batch join the queue together when it runs:
    with 8 frames of lag, the host's status of the 4th batched frame waits
    for the batch and for 8 more frames."""
    slam = _port(frame_batch=B)
    _track(slam, seq, [0])
    for f in range(1, 4):
        _track(slam, seq, [f])
        assert not slam._pending and len(slam._batch) == f
    _track(slam, seq, [4])
    assert [p[0] for p in slam._pending] == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# localisation mode: VO points, no insertion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vo_case(jax_run, seq):
    """JAX's final state, the next frame (JAX's frame function, carried
    across), and the close configuration of each package."""
    s, right = seq
    f = N_RUN
    jslam = jax_run["slam"]
    jf = jslam._frame_fn(jnp.asarray(s.images[f], jnp.float32),
                         jnp.asarray(right[f], jnp.float32), f,
                         s.timestamps[f])
    tst, tts = _carried(jax_run["state"], jax_run["ts"])
    tf = convert.frame_from_numpy(_fields(jf), device="cpu")
    return (jax_run["state"], jax_run["ts"], jf, tst, tts, tf,
            close_cfg(jconfig), close_cfg(tconfig))


def test_vo_points_in_motion_model_match_jax(vo_case):
    """track_with_motion_model in localisation mode at a 4.8 m close
    threshold: VO points exist (the last frame's close keypoints with no
    map point), some are matched and used by the pose LM as inliers, and
    the result agrees with JAX's: pose within 1e-4 (a pose LM over a few
    hundred rows summed in another order), inlier counts within 2, point
    ids nearly the same."""
    jst, jts, jf, tst, tts, tf, jcfg, tcfg = vo_case
    j_pids, j_opt, j_ok = jax.jit(
        lambda st, ts, fr: jtracking.track_with_motion_model(
            st, ts, fr, jcfg, jnp.asarray(True)))(jst, jts, jf)
    ttracking.vo_candidates.reset()
    ttracking.vo_inliers.reset()
    t_pids, t_opt, t_ok = ttracking.track_with_motion_model(
        tst, tts, tf, tcfg, True)
    n_vo = int(ttracking.vo_point_mask(
        tts, resolve_replaced(tst, tts.last_pids), tcfg, True).sum())
    vo_inliers = int((t_opt.inliers & (t_pids < 0)).sum())
    # the module's counts, read here as chip_smoke.py reads them
    assert int(ttracking.vo_candidates) == n_vo
    assert int(ttracking.vo_inliers) == vo_inliers
    print(f"VO candidates {n_vo}, VO inliers {vo_inliers} of "
          f"{int(t_opt.n_inliers)}")
    assert n_vo > 0 and vo_inliers > 0          # measured: 28 and 9
    assert bool(t_ok) == bool(j_ok) is True
    _same_pose(t_opt.T.numpy(), j_opt.T, 1e-4)
    assert abs(int(t_opt.n_inliers) - int(j_opt.n_inliers)) <= 2
    j_vo_inl = int(np.sum(np.asarray(j_opt.inliers) &
                          (np.asarray(j_pids) < 0)))
    assert abs(vo_inliers - j_vo_inl) <= 2
    assert _jaccard(t_pids.numpy(), j_pids) >= 0.98


def test_vo_branch_outside_localisation_gives_the_same_bits(vo_case,
                                                            monkeypatch):
    """Outside localisation mode the port skips the VO branch; running it
    with an all-False mask, as the JAX step does, gives the same bits."""
    _, _, _, tst, tts, tf, _, tcfg = vo_case
    skip = ttracking.track_with_motion_model(tst, tts, tf, tcfg, False)
    monkeypatch.setattr(ttracking, "vo_point_mask",
                        lambda ts, pids, cfg, loc: torch.zeros_like(
                            ts.last_valid))
    run = ttracking.track_with_motion_model(tst, tts, tf, tcfg, True)
    assert torch.equal(skip[0], run[0]) and torch.equal(skip[2], run[2])
    for f, x, y in zip(skip[1]._fields, skip[1], run[1]):
        assert torch.equal(x, y), f


def test_track_step_in_localisation_mode_matches_jax(vo_case):
    """The whole tracking step with loc_only: status, pose (1e-4), the
    keyframe decision and the tracked point ids as JAX's."""
    jst, jts, jf, tst, tts, tf, jcfg, tcfg = vo_case
    j_state, j_ts, j_pids, j_hud = jax.jit(jtracking.build_track_step(jcfg))(
        jst, jts, jf, jnp.asarray(True))
    ttracking.need_close_frames.reset()
    t_state, t_ts, t_pids, t_hud = ttracking.build_track_step(tcfg)(
        tst, tts, tf, True)
    # need_close by the reference's rule (Tracking.cc:1002-1037), counted
    thd = tcfg.camera.th_depth * tcfg.camera.baseline
    close = tf.valid & (tf.depth > 0) & (tf.depth < thd)
    n_tc, n_ntc = int((close & (t_pids >= 0)).sum()), \
        int((close & (t_pids < 0)).sum())
    need_close = n_tc < tcfg.tracking.close_depth_n and \
        n_ntc > tcfg.tracking.close_trackable_min
    assert int(ttracking.need_close_frames) == int(need_close)
    j_hud = np.asarray(j_hud)
    np.testing.assert_array_equal(t_hud.numpy()[[0, 2, 3, 4]],
                                  j_hud[[0, 2, 3, 4]])
    assert abs(int(t_hud[1]) - int(j_hud[1])) <= 2
    _same_pose(t_ts.T.numpy(), j_ts.T, 1e-4)
    assert _jaccard(t_pids.numpy(), j_pids) >= 0.98


def test_full_step_in_localisation_mode_inserts_nothing(jax_run, seq):
    """The first batch in which JAX inserted a keyframe, from JAX's state
    before it: in mapping mode the port inserts one too; in localisation
    mode neither package does, nor adds points, and the poses agree within
    POSE_ATOL."""
    s, right = seq
    snaps = jax_run["snaps"]
    # batches 1-4, 5-8, 9-12 run when their last frame is tracked
    last = next(e for e in (4, 8, 12)
                if int(snaps[e + 1][0].next_kf) > int(snaps[e][0].next_kf))
    frames = list(range(last - B + 1, last + 1))
    jst, jts = snaps[last]                     # before the batch's dispatch
    stacked = tuple(jnp.stack([jnp.asarray(a[f], jnp.float32)
                               for f in frames]) for a in (s.images, right))
    runs = {}
    for loc in (False, True):
        jslam = jax_run["slam"]
        st, ts, _, _ = jslam._super_step(
            jst, jts, stacked, jnp.asarray(frames, jnp.int32),
            jnp.asarray(s.timestamps[frames], jnp.float32),
            jnp.ones(B, bool), jnp.asarray(loc))
        slam = _port(frame_batch=B)
        slam.state, slam.ts = _carried(jst, jts)
        slam.localization_only = loc
        slam._batch = [((torch.from_numpy(s.images[f]),
                         torch.from_numpy(right[f])), f,
                        float(s.timestamps[f])) for f in frames]
        slam._dispatch_batch()
        runs[loc] = (st, ts, slam)
    jst_m, _, t_m = runs[False]
    assert int(t_m.state.next_kf) == int(jst_m.next_kf) > int(jst.next_kf)
    jst_l, jts_l, t_l = runs[True]
    assert int(t_l.state.next_kf) == int(jst_l.next_kf) == int(jst.next_kf)
    assert int(t_l.state.next_mp) == int(jst_l.next_mp) == int(jst.next_mp)
    _same_pose(t_l.ts.traj[frames, :7].numpy(),
               np.asarray(jts_l.traj)[frames, :7], POSE_ATOL)
    assert bool((t_l.ts.traj[frames, 15] > 0.5).all())


# ---------------------------------------------------------------------------
# map checkpoints, and localisation on a saved map
# ---------------------------------------------------------------------------

def test_checkpoints_round_trip_between_packages(jax_run, tmp_path):
    """A JAX checkpoint loads in the port, and a port checkpoint in JAX,
    field for field; the format is the same npz (version 1)."""
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcheckpoint.save_map(jax_run["state"], jp)
    t = tcheckpoint.load_map(jp, device="cpu")
    for f, a in _fields(jax_run["state"]).items():
        np.testing.assert_array_equal(getattr(t, f).numpy(), a, err_msg=f)
    tcheckpoint.save_map(t, tp)
    j = jcheckpoint.load_map(tp)
    for f, a in _fields(jax_run["state"]).items():
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), a,
                                      err_msg=f)
    assert sorted(np.load(jp).files) == sorted(np.load(tp).files)
    assert int(np.load(tp)["__version__"]) == 1


def test_checkpoint_errors_match_jax(jax_run, tmp_path):
    fields = _fields(jax_run["state"])
    newer = str(tmp_path / "newer.npz")
    np.savez(newer, __version__=np.asarray(2), **fields)
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, __version__=np.asarray(1),
             **{k: v for k, v in fields.items() if k != "kf_pose"})
    for path, match in ((newer, "newer than supported"),
                        (partial, r"missing fields: \['kf_pose'\]")):
        with pytest.raises(ValueError, match=match):
            tcheckpoint.load_map(path)
        with pytest.raises(ValueError, match=match):
            jcheckpoint.load_map(path)


@pytest.fixture(scope="module")
def localised(jax_run, seq, tmp_path_factory):
    """JAX's map saved by JAX, loaded by JAX (the same session) and by a
    fresh port session, both in localisation mode over frames LOC."""
    path = str(tmp_path_factory.mktemp("maps") / "map.npz")
    jslam = jax_run["slam"]
    jslam.save_map(path)
    jslam.load_map(path)
    jslam.activate_localization_mode()
    tslam = _port(frame_batch=B)
    tslam.load_map(path)
    assert tslam.status == LOST and int(tslam.ts.ref_kf) == 0
    tslam.activate_localization_mode()
    tslam.frame_count = jslam.frame_count
    for slam in (jslam, tslam):
        _track(slam, seq, range(*LOC))
        slam.flush()
    return jslam, tslam


def test_localisation_on_a_saved_map_matches_jax(jax_run, localised):
    """Tracked again on the loaded map: both OK on every frame, no keyframe
    or point added, poses within POSE_ATOL of each other.  The first frame
    (tracked against keyframe 0) lands within 5e-3 of the pose the mapping
    session gave it.  The second one need not: the JAX session starts its
    constant-velocity model from the identity as the last pose after
    load_map, so that frame's prediction is off by the first frame's pose,
    and the port does the same (ROADMAP, Queue 3)."""
    jslam, tslam = localised
    assert tslam.status == jslam.status == OK
    assert int(tslam.state.next_kf) == int(jax_run["state"].next_kf)
    assert int(tslam.state.next_mp) == int(jax_run["state"].next_mp)
    tp, jp = tslam.poses_twc(), jslam.poses_twc()
    assert tp.shape == jp.shape == (LOC[1] - LOC[0], 7)
    _same_pose(tp, jp, POSE_ATOL)
    _same_pose(tp[0], jax_run["poses"][LOC[0]], 5e-3)


# ---------------------------------------------------------------------------
# exports and getters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["save_trajectory_tum",
                                  "save_keyframe_trajectory_tum",
                                  "save_trajectory_kitti"])
def test_exports_match_jax(jax_run, tmp_path, name):
    """On the same state, the same lines: every number within 2e-6 (the
    same float32 state through the same compositions; the files print 6-7
    decimals)."""
    tslam = _carried_session(jax_run)
    jslam = JSLAM(small_cfg(jconfig))
    jslam.state, jslam.ts = jax_run["state"], jax_run["ts"]
    jslam.frame_count, jslam.status = jax_run["frame_count"], OK
    getattr(tslam, name)(str(tmp_path / "t.txt"))
    getattr(jslam, name)(str(tmp_path / "j.txt"))
    t = np.loadtxt(tmp_path / "t.txt", ndmin=2)
    j = np.loadtxt(tmp_path / "j.txt", ndmin=2)
    rows = {"save_keyframe_trajectory_tum": int(jax_run["state"].n_kf)}
    assert t.shape == j.shape and t.shape[0] == rows.get(name, N_RUN)
    if name == "save_trajectory_kitti":
        np.testing.assert_allclose(t, j, rtol=2e-6, atol=2e-6)
    else:
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        q_t, q_j = t[:, [7, 4, 5, 6]], j[:, [7, 4, 5, 6]]
        _same_pose(np.concatenate([q_t, t[:, 1:4]], 1),
                   np.concatenate([q_j, j[:, 1:4]], 1), 2e-6)


def test_getters_and_map_changed(jax_run):
    """get_tracking_state, get_tracked_map_points and
    get_tracked_keypoints_un as JAX's on the same state; map_changed
    follows the big-change counter: True once after it moves."""
    tslam = _carried_session(jax_run)
    jts = jax_run["ts"]
    assert tslam.get_tracking_state() == OK
    np.testing.assert_array_equal(tslam.get_tracked_map_points(),
                                  np.asarray(jts.last_pids))
    uv, valid = tslam.get_tracked_keypoints_un()
    np.testing.assert_array_equal(uv, np.asarray(jts.last_uv))
    np.testing.assert_array_equal(valid, np.asarray(jts.last_valid))
    assert int(valid.sum()) > 100
    assert tslam.map_changed() is False
    tslam.state = tslam.state._replace(
        big_change=tslam.state.big_change + 1)
    assert tslam.map_changed() is True
    assert tslam.map_changed() is False


# ---------------------------------------------------------------------------
# the current-frame view
# ---------------------------------------------------------------------------

def test_draw_current_frame_matches_jax(jax_run, seq, recorded, tmp_path,
                                        monkeypatch):
    """draw_current_frame on the JAX session's final state and last image:
    the port draws the primitives JAX's draws (the keypoint sets, their
    colours and the status text, letter for letter) into a w x (h + 26)
    PNG.  JAX's method runs on a stand-in holding that state, since
    other tests go on tracking with the JAX session."""
    import types
    from orb_slam2_tpu_torch.io.png import read_png
    from orb_slam2_tpu_torch.viz import viewer as tviewer
    from test_torch_viz import _same
    last = seq[0].images[N_RUN - 1]
    JSLAM.draw_current_frame(types.SimpleNamespace(
        flush=lambda: None, _last_img=last, ts=jax_run["ts"],
        state=jax_run["state"], status=OK, localization_only=False,
        cfg=jax_run["slam"].cfg), str(tmp_path / "j.png"))
    tslam = _carried_session(jax_run)
    tslam._last_img = last
    scenes = []
    orig = tviewer.frame_scene
    monkeypatch.setattr(tviewer, "frame_scene",
                        lambda *a, **k: scenes.append(orig(*a, **k)) or
                        scenes[-1])
    out = tslam.draw_current_frame(str(tmp_path / "t.png"))
    sc = scenes[0]
    _same(list(sc.marks) + list(sc.texts), recorded)
    jts, jst = jax_run["ts"], jax_run["state"]
    n = int((np.asarray(jts.last_valid) & (np.asarray(jts.last_pids) >= 0)
             ).sum())
    assert n > 100
    assert sc.texts[0].text == (
        f"SLAM MODE | KFs: {int(jst.n_kf)}, MPs: {int(jst.n_mp)}, "
        f"Matches: {n}")
    assert read_png(out).shape == (240 + 26, 320, 3)


def test_track_calls_keep_the_last_image(seq):
    """track_mono, track_stereo and track_rgbd keep their (left) image for
    draw_current_frame, as the JAX session does."""
    s, right = seq
    for sensor, track, img in (
            (tconfig.MONOCULAR, lambda sl: sl.track_mono(s.images[0], 0.0),
             s.images[0]),
            (tconfig.STEREO, lambda sl: sl.track_stereo(s.images[1],
                                                        right[1], 0.0),
             s.images[1]),
            (tconfig.RGBD, lambda sl: sl.track_rgbd(s.images[2], s.depths[2],
                                                    0.0), s.images[2])):
        slam = _port(small_cfg(tconfig, sensor=sensor))
        assert slam._last_img is None
        track(slam)
        np.testing.assert_array_equal(slam._last_img, img)
