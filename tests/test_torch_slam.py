"""The whole monocular slice of the port against the JAX package, on the
CPU, on tests/test_e2e.py's small configuration with the vocabulary off in
both (no BoW, loop closing or relocalisation: the path the port covers).

(a) From one JAX state after 15 frames, carried across with `convert.py`:
    one fused per-frame step, and each keyframe-integration stage
    (triangulate, fuse, a local-BA chunk, the culls).  The
    pose agrees to 1e-4 (a pose LM over ~300 points summed in another
    order) and the tracked point-id sets nearly agree, since a handful of
    borderline matches (a distance or chi^2 at its threshold) can flip.
(b) A 40-frame run of each: both track >= 80% of frames under the 0.02 m
    ATE gate of test_mono_ate_gate, and their ATEs are within 0.005 m.
    Trajectories cannot match bit for bit: the RANSAC streams differ.
(c) Two port runs are bit-identical.
(d) `SLAM(cfg)` without a device runs on CUDA, and raises without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.io import evaluate, synthetic
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline.tracking import HUD_NEED_KF, HUD_STATUS

N_FRAMES, SNAP = 40, 15


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; the port's
    small tensors gain nothing from intra-op threads, which then only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(m):
    """tests/test_e2e.py's small monocular configuration."""
    cam = m.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                         height=240, fps=30.0, bf=0.0, th_depth=35.0)
    return m.SLAMConfig(
        camera=cam, orb=m.ORBConfig(n_features=500, max_keypoints=512),
        cap=m.Capacity(max_keyframes=96, max_points=6144, max_obs_per_kf=512,
                       max_frames=512, local_ba_points=2048))


def _fields(nt):
    return {f: np.array(v) for f, v in zip(nt._fields, nt)}


def _ate(slam, seq):
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), seq.timestamps)
    return evaluate.ate_rmse(est[ie], seq.poses_twc[ig], align_scale=True), \
        len(ie)


def _run_port(seq, n):
    slam = tsystem.SLAM(small_cfg(tconfig), device="cpu")
    for f in range(n):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return slam


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(small_cfg(jconfig).camera, n_frames=N_FRAMES,
                              n_points=300, trajectory="xyz", seed=0)


@pytest.fixture(scope="module")
def jax_run(seq, tmp_path_factory):
    """The JAX session over 40 frames, with its state after SNAP frames."""
    no_vocab = tmp_path_factory.mktemp("vocab") / "absent.npz"
    slam = JSLAM(small_cfg(jconfig), vocab_path=str(no_vocab))
    assert slam._transform is None
    snap = None
    for f in range(N_FRAMES):
        if f == SNAP:       # JAX arrays are immutable: a reference is a copy
            snap = (slam.state, slam.ts)
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    return slam, snap


@pytest.fixture(scope="module")
def port_run(seq):
    return _run_port(seq, N_FRAMES)


def _carried(snap):
    """The JAX state as it was (so JAX's compiled steps are reused) and the
    same state carried into the port through numpy."""
    jst, jts = snap
    return (jst, jts,
            convert.map_state_from_numpy(_fields(jst), device="cpu"),
            convert.track_state_from_numpy(_fields(jts), device="cpu"))


def _same_pose(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _jaccard(a, b):
    a, b = set(np.asarray(a)[np.asarray(a) >= 0].tolist()), \
        set(np.asarray(b)[np.asarray(b) >= 0].tolist())
    return len(a & b) / max(len(a | b), 1)


def test_full_step_from_carried_state_matches_jax(jax_run, seq):
    jslam, snap = jax_run
    jst, jts, tst, tts = _carried(snap)
    assert int(jst.kf_valid.sum()) >= 2
    img = seq.images[SNAP]
    # the argument types `SLAM.track_mono` passes, so the compiled step is
    # reused
    j_state, j_ts, _, j_hud = jslam._full_step(
        jst, jts, (jnp.asarray(img, jnp.float32),), SNAP,
        seq.timestamps[SNAP], jnp.asarray(False))
    step = tsystem.build_full_step(small_cfg(tconfig), "cpu")
    t_state, t_ts, _, t_hud = step(tst, tts, torch.from_numpy(img), SNAP,
                                   float(seq.timestamps[SNAP]))
    j_hud, t_hud = np.asarray(j_hud), t_hud.numpy()
    assert t_hud[HUD_STATUS] == j_hud[HUD_STATUS] == 2
    assert t_hud[HUD_NEED_KF] == j_hud[HUD_NEED_KF]
    _same_pose(t_ts.T.numpy(), j_ts.T, 1e-4)
    assert _jaccard(t_ts.last_pids.numpy(), j_ts.last_pids) >= 0.95
    assert abs(int(t_state.n_mp) - int(j_state.n_mp)) <= \
        0.02 * int(j_state.n_mp) + 2
    assert int(t_ts.map_stage) == int(j_ts.map_stage)
    assert int(t_ts.map_kf) == int(j_ts.map_kf)
    for f in ("traj", "T", "velocity", "last_T"):
        np.testing.assert_allclose(getattr(t_ts, f).numpy(),
                                   np.asarray(getattr(j_ts, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


STAGES = {"triangulate": 0, "fuse": 1, "local_ba_chunk": 2, "cull": 5}


@pytest.mark.parametrize("stage", list(STAGES))
def test_mapping_stage_from_carried_state_matches_jax(jax_run, stage):
    """Each keyframe-integration stage (`mapping_stage` at that stage) on
    the newest keyframe of the same state.  Poses agree to 1e-4 and point
    positions to 1e-3 where both hold a point (the BA chunk is 5 LM
    iterations); the observation tables nearly agree (>= 99% of the
    entries that either side fills, and as many entries changed)."""
    jslam, snap = jax_run
    jst, jts, tst, tts = _carried(snap)
    k, st = int(jst.next_kf) - 1, STAGES[stage]
    j, jts2 = jslam._mapping_stage(jst, jts._replace(
        map_kf=jnp.asarray(k, jnp.int32), map_stage=jnp.asarray(st, jnp.int32)))
    t, tts2 = tsystem.mapping_stage(tst, tts._replace(
        map_kf=torch.tensor(k, dtype=torch.int32),
        map_stage=torch.tensor(st, dtype=torch.int32)), small_cfg(tconfig))
    last = st + 1 == tsystem.n_stages(small_cfg(tconfig))
    assert int(tts2.map_stage) == int(jts2.map_stage) == (0 if last
                                                         else st + 1)
    assert int(tts2.map_kf) == int(jts2.map_kf) == (-1 if last else k)
    np.testing.assert_allclose(float(tts2.ba_lam), float(jts2.ba_lam),
                               rtol=1e-5)
    t = convert.to_numpy(t)
    for f in ("kf_valid", "next_kf", "kf_parent"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t["kf_pose"], np.asarray(j.kf_pose), rtol=0,
                               atol=1e-4)
    jv, tv = np.asarray(j.mp_valid), t["mp_valid"]
    assert (jv == tv).mean() >= 0.99
    both = jv & tv
    np.testing.assert_allclose(t["mp_pos"][both], np.asarray(j.mp_pos)[both],
                               rtol=0, atol=1e-3)
    jo, bo = np.asarray(j.kf_obs), np.asarray(jst.kf_obs)
    live = (jo >= 0) | (t["kf_obs"] >= 0)
    assert (t["kf_obs"] == jo)[live].mean() >= 0.99
    changed_j, changed_t = (jo != bo).sum(), (t["kf_obs"] != bo).sum()
    assert abs(int(changed_t) - int(changed_j)) <= 0.02 * changed_j + 1
    if stage == "triangulate":
        made = int(j.next_mp) - int(jst.next_mp)
        assert made > 0
        assert abs(int(t["next_mp"]) - int(j.next_mp)) <= 0.05 * made + 2


def test_run_tracks_like_jax(jax_run, port_run, seq):
    jslam, _ = jax_run
    j_ate, j_n = _ate(jslam, seq)
    t_ate, t_n = _ate(port_run, seq)
    assert j_n >= 0.8 * N_FRAMES and t_n >= 0.8 * N_FRAMES, (j_n, t_n)
    assert j_ate <= 0.02 and t_ate <= 0.02, (j_ate, t_ate)
    assert abs(t_ate - j_ate) <= 0.005, (t_ate, j_ate)


def test_state_layout_matches_jax(jax_run, port_run):
    """After a whole run every field has JAX's dtype and shape, and lies
    on the session's device."""
    jslam, _ = jax_run
    for jnt, tnt in ((jslam.state, port_run.state), (jslam.ts, port_run.ts)):
        for f, j, t in zip(jnt._fields, jnt, tnt):
            assert t.device.type == "cpu", f
            assert tuple(t.shape) == tuple(j.shape), f
            assert t.numpy().dtype == np.asarray(j).dtype, f


def test_two_port_runs_are_bit_identical(port_run, seq):
    again = _run_port(seq, N_FRAMES)
    a, b = port_run.poses_twc(), again.poses_twc()
    assert a.shape == b.shape and a.shape[0] >= 0.8 * N_FRAMES
    assert np.array_equal(a, b)


def test_slam_runs_on_cuda_by_default():
    cfg = small_cfg(tconfig)
    if torch.cuda.is_available():
        assert tsystem.SLAM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsystem.SLAM(cfg)
