"""The whole monocular slice of the port against the JAX package, on the
CPU, on tests/test_e2e.py's small configuration, with each package's
default vocabulary on (BoW on every keyframe, loop detection,
relocalisation when lost): `SLAM(cfg)` as users run it.

(a) From one JAX state after 15 frames, carried across with `convert.py`:
    one fused per-frame step (with the vocabulary, and without it: the
    vocabulary-free configuration stays covered), and each
    keyframe-integration stage (triangulate, fuse, a local-BA chunk, the
    culls).  The pose agrees to 1e-4 (a pose LM over ~300 points summed in
    another order) and the tracked point-id sets nearly agree, since a
    handful of borderline matches (a distance or chi^2 at its threshold)
    can flip.
(b) A 40-frame run of each: both track >= 80% of frames under the 0.02 m
    ATE gate of test_mono_ate_gate, and their ATEs are within 0.005 m;
    every keyframe carries a BoW vector equal to JAX's where the keyframe
    is the same.  Trajectories cannot match bit for bit: the RANSAC
    streams differ.
(c) Two port runs are bit-identical.
(d) `SLAM(cfg)` without a device runs on CUDA, and raises without one.
(e) On the same carried state and the same RANSAC draws (JAX's, from its
    keys): the relocalisation step on a trackable frame; Sim3 verification
    and loop correction of the pair (newest keyframe, keyframe 0); the
    post-loop global BA merged after two chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.ba.async_gba import AsyncGBA as JAsyncGBA
from orb_slam2_tpu.io import evaluate, synthetic
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ba.async_gba import AsyncGBA as TAsyncGBA
from orb_slam2_tpu_torch.pipeline import loopclosing as tloop
from orb_slam2_tpu_torch.pipeline import reloc as treloc
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
def jax_run(seq):
    """The JAX session over 40 frames, with its state after SNAP frames."""
    slam = JSLAM(small_cfg(jconfig))
    assert slam._transform is not None
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
    """Poses equal up to the quaternion's sign."""
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 1 and np.dot(a[:4], b[:4]) < 0:
        a = np.concatenate([-a[:4], a[4:]])
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _jaccard(a, b):
    a, b = set(np.asarray(a)[np.asarray(a) >= 0].tolist()), \
        set(np.asarray(b)[np.asarray(b) >= 0].tolist())
    return len(a & b) / max(len(a | b), 1)


@pytest.mark.parametrize("vocab", ["on", "off"])
def test_full_step_from_carried_state_matches_jax(jax_run, port_run, seq,
                                                  vocab):
    """With the vocabulary off the port's step skips the BoW of an inserted
    keyframe; nothing else in the step depends on it."""
    jslam, snap = jax_run
    jst, jts, tst, tts = _carried(snap)
    assert int(jst.kf_valid.sum()) >= 2
    img = seq.images[SNAP]
    # the argument types `SLAM.track_mono` passes, so the compiled step is
    # reused
    j_state, j_ts, _, j_hud = jslam._full_step(
        jst, jts, (jnp.asarray(img, jnp.float32),), SNAP,
        seq.timestamps[SNAP], jnp.asarray(False))
    step = tsystem.build_full_step(
        small_cfg(tconfig), "cpu",
        port_run._transform if vocab == "on" else None)
    t_state, t_ts, _, t_hud = step(tst, tts, (torch.from_numpy(img),), SNAP,
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
    k = int(j_ts.ref_kf)
    if vocab == "off":
        assert torch.equal(t_state.kf_bow, tst.kf_bow)
    elif t_hud[HUD_NEED_KF]:
        np.testing.assert_allclose(t_state.kf_bow[k].numpy(),
                                   np.asarray(j_state.kf_bow)[k], rtol=0,
                                   atol=1e-6)


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
    # every keyframe has its BoW vector; where both sessions made the same
    # keyframe (same frame), it is JAX's to 1e-6
    tv = port_run.state.kf_valid.numpy()
    t_bow = port_run.state.kf_bow.numpy()
    assert tv.sum() >= 3 and (np.abs(t_bow[tv]).sum(1) > 0.99).all()
    j_fid = np.asarray(jslam.state.kf_frame_id)
    same = tv & np.asarray(jslam.state.kf_valid) & \
        (port_run.state.kf_frame_id.numpy() == j_fid)
    assert same[:2].all()
    np.testing.assert_allclose(t_bow[same], np.asarray(jslam.state.kf_bow)[
        same], rtol=0, atol=1e-6)


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


def test_session_without_vocabulary_file(tmp_path):
    """An absent vocabulary file means no vocabulary, as in JAX: no BoW,
    relocalisation or loop closing (the configuration of the first slice)."""
    slam = tsystem.SLAM(small_cfg(tconfig), device="cpu",
                        vocab_path=str(tmp_path / "absent.npz"))
    assert slam.vocab is None and slam._transform is None
    default = tsystem.SLAM(small_cfg(tconfig), device="cpu")
    assert default.vocab.n_words == 9876


def test_slam_runs_on_cuda_by_default():
    cfg = small_cfg(tconfig)
    if torch.cuda.is_available():
        assert tsystem.SLAM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsystem.SLAM(cfg)


# ---------------------------------------------------------------------------
# (e) relocalisation, loop verification and correction, GBA merge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried(jax_run, port_run):
    jslam, snap = jax_run
    return jslam, port_run, _carried(snap)


def test_reloc_step_from_carried_state_matches_jax(carried, seq):
    jslam, tslam, (jst, _, tst, _) = carried
    img = jnp.asarray(seq.images[SNAP], jnp.float32)
    jframe = jslam._frame_fn(img, SNAP, seq.timestamps[SNAP])
    tframe = convert.frame_from_numpy(_fields(jframe), device="cpu")
    key = jax.random.PRNGKey(7)
    u = np.stack([np.asarray(jax.random.uniform(k, (treloc.PNP_ITERS,
                                                    treloc.PNP_SAMPLE)))
                  for k in jax.random.split(key, treloc.N_CAND)])
    j_ok, j_T, j_pids, j_cand = jslam._reloc_step(jst, jframe, key)
    t_ok, t_T, t_pids, t_cand = treloc.build_reloc_step(
        small_cfg(tconfig), tslam._transform)(tst, tframe, torch.from_numpy(u))
    assert bool(j_ok) and bool(t_ok)
    assert int(t_cand) == int(j_cand)
    _same_pose(t_T.numpy(), j_T, 1e-4)
    assert _jaccard(t_pids.numpy(), j_pids) >= 0.95


@pytest.fixture(scope="module")
def loop_pair(carried):
    """verify() of (newest keyframe, keyframe 0) in both packages, on the
    same Sim3 RANSAC draws."""
    jslam, _, (jst, _, tst, _) = carried
    k = int(jst.next_kf) - 1
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (tloop.SIM3_ITERS, 3)))
    j = jslam._loop_verify(jst, jnp.asarray(k), jnp.asarray(0), key)
    t = tloop.verify(tst, k, 0, torch.from_numpy(u), small_cfg(tconfig))
    return k, j, t


def test_loop_verify_from_carried_state_matches_jax(loop_pair):
    """The BoW match count is exact; the Sim3 inliers and the total matches
    within 2 (a reprojection error at its gate can flip); Scm to 1e-3."""
    _, (j_ok, j_S, j_lp, j_st), (t_ok, t_S, t_lp, t_st) = loop_pair
    assert bool(t_ok) == bool(j_ok)
    j_st, t_st = np.asarray(j_st), t_st.numpy()
    assert t_st[0] == j_st[0]
    assert np.abs(t_st[1:] - j_st[1:]).max() <= 2, (t_st, j_st)
    _same_pose(t_S.numpy(), j_S, 1e-3)
    assert _jaccard(t_lp.numpy(), j_lp) >= 0.95


def test_loop_correct_from_carried_state_matches_jax(carried, loop_pair):
    """correct() with JAX's verified Scm and loop points in both: poses to
    1e-3 (a 20-step pose-graph LM with CG), points to 1e-2 where both hold
    one, the observation tables nearly equal."""
    jslam, _, (jst, _, tst, _) = carried
    k, (_, j_S, j_lp, _), _ = loop_pair
    j = jslam._loop_correct(jst, jnp.asarray(k), jnp.asarray(0), j_S, j_lp)
    t = tloop.correct(tst, k, 0, torch.from_numpy(np.array(j_S)),
                      torch.from_numpy(np.array(j_lp)), small_cfg(tconfig))
    t = convert.to_numpy(t)
    for f in ("kf_valid", "loop_edge", "big_change"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t["kf_pose"], np.asarray(j.kf_pose), rtol=0,
                               atol=1e-3)
    both = t["mp_valid"] & np.asarray(j.mp_valid)
    assert (t["mp_valid"] == np.asarray(j.mp_valid)).mean() >= 0.99
    np.testing.assert_allclose(t["mp_pos"][both], np.asarray(j.mp_pos)[both],
                               rtol=0, atol=1e-2)
    jo = np.asarray(j.kf_obs)
    live = (jo >= 0) | (t["kf_obs"] >= 0)
    assert (t["kf_obs"] == jo)[live].mean() >= 0.99


def test_gba_merge_after_two_chunks_matches_jax(carried):
    """Two chunks of 2 LM iterations (PCG, damping carried) on the snapshot,
    merged: poses and points to 1e-3."""
    jslam, _, (jst, jts, tst, tts) = carried
    jg, tg = JAsyncGBA(small_cfg(jconfig)), TAsyncGBA(small_cfg(tconfig))
    jg.start(jst, 10)
    tg.start(tst, 10)
    for _ in range(2):
        assert not jg.step() and not tg.step()
    np.testing.assert_allclose(float(tg.carry[2]), float(jg.carry[2]),
                               rtol=1e-5)
    j, jT = jg.merge(jst, jts.T, jts.ref_kf)
    t, tT = tg.merge(tst, tts.T, tts.ref_kf)
    np.testing.assert_allclose(t.kf_pose.numpy(), np.asarray(j.kf_pose),
                               rtol=0, atol=1e-3)
    v = np.asarray(j.mp_valid)
    np.testing.assert_allclose(t.mp_pos.numpy()[v], np.asarray(j.mp_pos)[v],
                               rtol=0, atol=1e-3)
    _same_pose(tT.numpy(), jT, 1e-3)
    assert int(t.big_change) == int(j.big_change)


def test_gba_snapshot_is_frozen_while_the_map_changes(carried):
    """The session writes its map in place each frame.  Between the GBA's
    start and its chunks a keyframe and a point are made and a snapshot
    keyframe moves, in the port's state in place and in JAX's as new
    arrays: the merge corrects the new keyframe through its spanning-tree
    parent and the new point through it, as JAX's does (1e-3)."""
    _, _, (jst, jts, tst, tts) = carried
    live = type(tst)(*(x.clone() for x in tst))
    jg, tg = JAsyncGBA(small_cfg(jconfig)), TAsyncGBA(small_cfg(tconfig))
    jg.start(jst, 4)
    tg.start(live, 4)
    new = _fields(jst)
    k = int(np.argmin(new["kf_valid"]))
    p = int(np.flatnonzero(new["kf_valid"])[-1])
    m = int(np.argmin(new["mp_valid"]))
    new["kf_pose"][p, 4:] += 0.01           # a local BA moved it
    new["kf_pose"][k] = new["kf_pose"][p]
    new["kf_pose"][k, 4] += 0.05
    new["kf_valid"][k], new["kf_parent"][k] = True, p
    new["mp_valid"][m] = True
    new["mp_pos"][m] = new["mp_pos"][np.flatnonzero(new["mp_valid"])[0]]
    new["mp_obs_kf"][m] = -1
    new["mp_obs_kf"][m, 0] = k
    jst = jst._replace(**{f: jnp.asarray(new[f]) for f in
                          ("kf_pose", "kf_valid", "kf_parent", "mp_valid",
                           "mp_pos", "mp_obs_kf")})
    for f in ("kf_pose", "kf_valid", "kf_parent", "mp_valid", "mp_pos",
              "mp_obs_kf"):
        getattr(live, f).copy_(torch.from_numpy(new[f]))
    assert not jg.step() and not tg.step()
    assert jg.step() and tg.step()
    j, jT = jg.merge(jst, jts.T, jts.ref_kf)
    t, tT = tg.merge(live, tts.T, tts.ref_kf)
    np.testing.assert_allclose(t.kf_pose.numpy(), np.asarray(j.kf_pose),
                               rtol=0, atol=1e-3)
    v = np.asarray(j.mp_valid)
    assert v[m]
    np.testing.assert_allclose(t.mp_pos.numpy()[v], np.asarray(j.mp_pos)[v],
                               rtol=0, atol=1e-3)
    _same_pose(tT.numpy(), jT, 1e-3)
