"""The stereo and RGB-D slice of the port against the JAX package, on the
CPU, at tests/test_e2e.py's small configurations (320x240, 500 features,
bf = 16) with each package's default vocabulary on.

Inputs come from the JAX renderer (seed 0, xyz trajectory); the right eye
is the same room rendered from `right_poses`.  The JAX side runs as the JAX
tests run it on the CPU: the extractor without Pallas, `pose_optimize` for
the pose LM.  Tolerances and their reasons stand in each test.

(a) Modules: camera (`unproject`, `stereo_right_u`), the right-eye render,
    the two-image extractor and its atlas, the SAD refinement, the stereo
    and RGB-D frame functions, `stereo_initialize`.
(b) From one JAX session per sensor (12 frames), carried across with
    `convert.py`: the fused per-frame step on a frame where JAX inserts a
    keyframe (so its depth points are made) and on one where it does not;
    each keyframe-integration stage; `create_depth_points`.
(c) The whole slice: a 30-frame port run per sensor tracks >= 90% of the
    frames under test_e2e's metric-ATE gates (0.06 m stereo, 0.02 m
    RGB-D); `SLAM(cfg)` without a device runs on CUDA or raises.  The
    frame-batched session is held against JAX's in
    tests/test_torch_session.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.core import camera as jcamera
from orb_slam2_tpu.frontend import atlas as jatlas
from orb_slam2_tpu.io import evaluate, synthetic
from orb_slam2_tpu.map import ops as jops
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import mapping as jmapping
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.core import camera as tcamera
from orb_slam2_tpu_torch.frontend import atlas as tatlas
from orb_slam2_tpu_torch.frontend import pyramid
from orb_slam2_tpu_torch.io import synthetic as tsynthetic
from orb_slam2_tpu_torch.map import ops as tops
from orb_slam2_tpu_torch.map.state import empty_map
from orb_slam2_tpu_torch.matching import hamming, search
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import init as tinit
from orb_slam2_tpu_torch.pipeline import mapping as tmapping
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_NEED_KF, HUD_STATUS,
                                                   empty_track_state)
from orb_slam2_tpu_torch.place.vocab import Vocabulary, build_transform

STEREO, RGBD = jconfig.STEREO, jconfig.RGBD
SENSORS = {"stereo": STEREO, "rgbd": RGBD}
N_RUN, N_JAX = 30, 12
# metric ATE gates of test_stereo_e2e / test_rgbd_e2e (tests/test_e2e.py)
ATE_GATE = {STEREO: 0.06, RGBD: 0.02}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; the port's
    small tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(m, sensor):
    """tests/test_e2e.py's small_cfg(sensor) for package config module m."""
    cam = m.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                         height=240, fps=30.0, bf=16.0, th_depth=35.0)
    return m.SLAMConfig(
        sensor=sensor, camera=cam,
        orb=m.ORBConfig(n_features=500, max_keypoints=512),
        cap=m.Capacity(max_keyframes=96, max_points=6144, max_obs_per_kf=512,
                       max_frames=512, local_ba_points=2048))


def _fields(nt):
    return {f: np.array(v) for f, v in zip(nt._fields, nt)}


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


def _images(seq, right, sensor, f):
    """The images `SLAM.track_stereo` / `track_rgbd` take at frame f."""
    return (seq.images[f], right[f] if sensor == STEREO else seq.depths[f])


@pytest.fixture(scope="module")
def seq():
    cam = small_cfg(jconfig, STEREO).camera
    s = synthetic.generate(cam, n_frames=N_RUN, n_points=300,
                           trajectory="xyz", seed=0)
    right = synthetic.generate(
        cam, n_frames=N_RUN, n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(s.poses_twc,
                                             cam.baseline)).images
    return s, right


@pytest.fixture(scope="module")
def transform():
    v = Vocabulary.load(tsystem.DEFAULT_VOCAB)
    cfg = small_cfg(tconfig, STEREO)
    return build_transform(v, pad_to=cfg.vocab.branching ** cfg.vocab.depth,
                           device="cpu")


# ---------------------------------------------------------------------------
# (a) modules
# ---------------------------------------------------------------------------

def test_unproject_and_stereo_right_u_match_jax():
    """Closed forms of a few products each: 1e-5 relative covers the
    ulps XLA and PyTorch may order differently."""
    rng = np.random.RandomState(0)
    K = np.array([200.0, 210.0, 160.0, 120.0], np.float32)
    uv = (rng.rand(64, 2) * [320, 240]).astype(np.float32)
    d = (0.5 + rng.rand(64) * 8).astype(np.float32)
    np.testing.assert_allclose(
        tcamera.unproject(*map(torch.from_numpy, (K, uv, d))).numpy(),
        np.asarray(jcamera.unproject(*map(jnp.asarray, (K, uv, d)))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcamera.stereo_right_u(torch.from_numpy(K), 16.0, torch.from_numpy(uv),
                               torch.from_numpy(d)).numpy(),
        np.asarray(jcamera.stereo_right_u(jnp.asarray(K), 16.0,
                                          jnp.asarray(uv), jnp.asarray(d))),
        rtol=1e-5, atol=1e-5)


def test_right_eye_render_matches_jax():
    """The port's numpy renderer against the OpenCV one: same poses, same
    random draws (texture, noise), so images differ only by interpolation
    round-off (measured max 0.44 of 255 at this size; gate 1.0 max, 0.1
    mean) and depths not at all."""
    jcam, tcam = small_cfg(jconfig, STEREO).camera, \
        small_cfg(tconfig, STEREO).camera
    twc = synthetic.xyz_trajectory(4)
    jr, tr = synthetic.right_poses(twc, jcam.baseline), \
        tsynthetic.right_poses(twc, tcam.baseline)
    np.testing.assert_array_equal(tr, jr)
    j = synthetic.generate(jcam, n_frames=4, n_points=4, seed=0,
                           poses_override=jr)
    t = tsynthetic.generate(tcam, n_frames=4, n_points=4, seed=0,
                            poses_override=tr)
    d = np.abs(t.images - j.images)
    assert d.max() <= 1.0 and d.mean() <= 0.1, (d.max(), d.mean())
    np.testing.assert_allclose(t.depths, j.depths, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.poses_twc, j.poses_twc)
    with pytest.raises(ValueError, match="poses_override"):
        tsynthetic.generate(tcam, n_frames=3, poses_override=tr)


@pytest.fixture(scope="module")
def two_image_features(seq):
    """JAX's and the port's two-image extraction of stereo pair 1."""
    s, right = seq
    pair = np.stack([s.images[1], right[1]])
    kw = dict(n_features=500, max_keypoints=512)
    jf, jat = jax.jit(jatlas.build_atlas_extractor(
        jconfig.ORBConfig(**kw), 240, 320, n_images=2, use_pallas=False,
        return_atlas=True))(jnp.asarray(pair))
    tf, tat = tatlas.build_atlas_extractor(
        tconfig.ORBConfig(**kw), 240, 320, device="cpu", n_images=2,
        return_atlas=True)(torch.from_numpy(pair))
    return jf, jat, tf, tat


def test_two_image_extractor_matches_jax(two_image_features):
    """Per image, test_torch_frontend's tolerances: >= 99% of slots with the
    same validity, octave and position (1e-3 px), responses to 1e-4,
    descriptors with median Hamming 0 and >= 98% within 4 bits.  The atlas
    within the resize tolerance there (XLA:CPU's resize is up to 5.5e-4
    off the f64 product on 0-255 pixels): 1e-3."""
    jf, jat, tf, tat = two_image_features
    assert tf.uv.shape == (2, 512, 2) and tat.shape == (16, 240, 320)
    np.testing.assert_allclose(tat.numpy(), np.asarray(jat), rtol=0,
                               atol=1e-3)
    for b in range(2):
        jv, tv = np.asarray(jf.valid[b]), tf.valid[b].numpy()
        assert jv.sum() > 300
        same = ((jv == tv) & (np.asarray(jf.octave[b]) ==
                              tf.octave[b].numpy()) &
                (np.abs(np.asarray(jf.uv[b]) - tf.uv[b].numpy()).max(-1)
                 <= 1e-3))
        assert same.mean() >= 0.99, (b, same.mean())
        np.testing.assert_allclose(tf.response[b].numpy()[same],
                                   np.asarray(jf.response[b])[same], rtol=0,
                                   atol=1e-4)
        v = jv & tv
        ham = (np.unpackbits(np.asarray(jf.desc[b])[v], axis=1) !=
               np.unpackbits(tf.desc[b].numpy()[v], axis=1)).sum(1)
        assert np.median(ham) == 0
        assert (ham <= 4).mean() >= 0.98, np.sort(ham)[-10:]


def test_two_image_extractor_equals_two_single_runs(seq, two_image_features):
    """Batching the pair changes no bit of either image's features."""
    _, _, tf, _ = two_image_features
    s, right = seq
    one = tatlas.build_atlas_extractor(
        tconfig.ORBConfig(n_features=500, max_keypoints=512), 240, 320,
        device="cpu")
    for b, img in enumerate((s.images[1], right[1])):
        for f, a1, a2 in zip(tf._fields, one(torch.from_numpy(img)), tf):
            assert torch.equal(a1, a2[b]), f


def test_sad_subpixel_matches_jax(two_image_features):
    """Both SADs on JAX's atlas and the same candidates (the port's L/R
    gate on JAX's features): ur within 1e-3 px and the best SAD within
    1e-4 relative on >= 99% of matched keypoints.  The eleven sums of 121
    terms run in another order, so a near-tie of two displacements can flip
    the argmin by one step; at most 1% may."""
    jf, jat, _, _ = two_image_features
    cfg = small_cfg(tconfig, STEREO)
    L = cfg.orb.n_levels
    fl = [torch.from_numpy(np.array(a[0])) for a in jf]
    fr = [torch.from_numpy(np.array(a[1])) for a in jf]
    uv_l, oct_l, desc_l, val_l = fl[0], fl[2], fl[4], fl[5]
    uv_r, oct_r, desc_r, val_r = fr[0], fr[2], fr[4], fr[5]
    sf = torch.tensor(cfg.orb.scale_factors, dtype=torch.float32)
    gate = ((torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1]) <=
             2.0 * sf[oct_l.long()][:, None]) &
            ((uv_l[:, None, 0] - uv_r[None, :, 0]) >= 0.1) &
            ((uv_l[:, None, 0] - uv_r[None, :, 0]) <=
             cfg.camera.bf / cfg.camera.baseline) &
            (torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1))
    res = search.match_descriptors(hamming.hamming_matrix(desc_l, desc_r),
                                   gate, cfg.match.th_high, None, val_l,
                                   val_r)
    matched = res.idx >= 0
    assert int(matched.sum()) > 200
    ur0 = torch.where(matched, uv_r[res.idx.long().clamp(min=0), 0], -1.0)
    shapes = pyramid.level_shapes(240, 320, L, cfg.orb.scale_factor)
    lh = np.array([h for h, _ in shapes], np.int32)
    lw = np.array([w for _, w in shapes], np.int32)
    j_ur, j_sad = jax.jit(jframe._sad_subpixel_atlas, static_argnums=3)(
        jat, jnp.asarray(lh), jnp.asarray(lw), L, jnp.asarray(uv_l.numpy()),
        jnp.asarray(ur0.numpy()), jnp.asarray(oct_l.numpy()),
        jnp.asarray(matched.numpy()), jnp.asarray(sf.numpy()))
    t_ur, t_sad = tframe._sad_subpixel_atlas(
        torch.from_numpy(np.array(jat)), torch.from_numpy(lh).long(),
        torch.from_numpy(lw).long(), L, uv_l, ur0, oct_l, matched, sf)
    m = matched.numpy()
    j_ur, j_sad = np.asarray(j_ur)[m], np.asarray(j_sad)[m]
    t_ur, t_sad = t_ur.numpy()[m], t_sad.numpy()[m]
    ok = (np.abs(t_ur - j_ur) <= 1e-3) & \
        (np.abs(t_sad - j_sad) <= 1e-4 * np.maximum(np.abs(j_sad), 1.0))
    assert ok.mean() >= 0.99, (ok.mean(), int((~ok).sum()))
    np.testing.assert_array_equal(np.isinf(t_sad), np.isinf(j_sad))


@pytest.fixture(scope="module", params=list(SENSORS))
def jax_session(request, seq):
    """A JAX session over N_JAX frames, with its state before each frame
    (JAX arrays are immutable: a reference is a copy)."""
    sensor = SENSORS[request.param]
    s, right = seq
    slam = JSLAM(small_cfg(jconfig, sensor))
    assert slam._transform is not None
    snaps = []
    for f in range(N_JAX):
        snaps.append((slam.state, slam.ts))
        imgs = _images(s, right, sensor, f)
        (slam.track_stereo if sensor == STEREO else slam.track_rgbd)(
            *imgs, s.timestamps[f])
    snaps.append((slam.state, slam.ts))
    return sensor, slam, snaps


def _carried(snap):
    jst, jts = snap
    return (jst, jts,
            convert.map_state_from_numpy(_fields(jst), device="cpu"),
            convert.track_state_from_numpy(_fields(jts), device="cpu"))


def _jax_frame(jslam, seq, sensor, f):
    s, right = seq
    imgs = _images(s, right, sensor, f)
    return jslam._frame_fn(*[jnp.asarray(a, jnp.float32) for a in imgs], f,
                           s.timestamps[f])


def test_frame_fn_matches_jax(jax_session, seq):
    """build_stereo_frame_fn / build_rgbd_frame_fn on one image pair or
    image and depth map: the matched (ur >= 0) keypoint sets agree (Jaccard
    >= 0.98); on keypoints both match, ur within 1e-2 px and depth within
    1e-3 m (a disparity of a few px turns ur's f32 round-off into depth
    ~1e-4 m)."""
    sensor, jslam, _ = jax_session
    f = 5
    jf = _jax_frame(jslam, seq, sensor, f)
    s, right = seq
    tfn = tsystem.build_frame_fn(small_cfg(tconfig, sensor), "cpu")
    tf = tfn(*[torch.from_numpy(a) for a in _images(s, right, sensor, f)],
             f, s.timestamps[f])
    same = (np.asarray(jf.valid) == tf.valid.numpy()) & \
        (np.abs(np.asarray(jf.uv_raw) - tf.uv_raw.numpy()).max(-1) <= 1e-3)
    assert same.mean() >= 0.99
    jm, tm = np.asarray(jf.ur) >= 0, tf.ur.numpy() >= 0
    assert jm.sum() > 200
    assert (jm & tm).sum() / (jm | tm).sum() >= 0.98
    b = jm & tm & same
    np.testing.assert_allclose(tf.ur.numpy()[b], np.asarray(jf.ur)[b],
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(tf.depth.numpy()[b], np.asarray(jf.depth)[b],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tf.depth.numpy() > 0, tm)
    np.testing.assert_allclose(tf.uv.numpy()[same], np.asarray(jf.uv)[same],
                               rtol=0, atol=1e-3)


def test_stereo_initialize_matches_jax(jax_session, seq):
    """From the same frame (JAX's, carried across): the same keyframe 0,
    the same point count, points within 1e-4 m (an unprojection)."""
    sensor, jslam, snaps = jax_session
    jf = _jax_frame(jslam, seq, sensor, 0)
    jst, jts = snaps[0]
    j_state, j_ts, j_ok = jslam._stereo_init(jst, jts, jf)
    cfg = small_cfg(tconfig, sensor)
    t_state, t_ts, t_ok = tinit.stereo_initialize(
        empty_map(cfg, "cpu"), empty_track_state(cfg, "cpu"),
        convert.frame_from_numpy(_fields(jf), device="cpu"), cfg)
    assert bool(t_ok) == bool(j_ok) is True
    assert int(t_ts.ref_kf) == int(j_ts.ref_kf) == 0
    assert int(t_state.next_kf) == int(j_state.next_kf) == 1
    assert int(t_state.next_mp) == int(j_state.next_mp) > 300
    t = convert.to_numpy(t_state)
    for f in ("mp_valid", "kf_obs", "mp_obs_kf", "mp_obs_kp", "mp_desc"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(j_state, f)),
                                      err_msg=f)
    for f in ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(j_state, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(t_ts.last_pids.numpy(), j_ts.last_pids)


def _insertion_frame(snaps):
    """The first frame after the bootstrap at which JAX inserted a
    keyframe."""
    for f in range(2, N_JAX):
        if int(snaps[f + 1][0].next_kf) > int(snaps[f][0].next_kf):
            return f
    raise AssertionError("the JAX session inserted no keyframe")


@pytest.mark.parametrize("kind", ["insert", "track"])
def test_full_step_from_carried_state_matches_jax(jax_session, seq,
                                                  transform, kind):
    """One fused step from JAX's state before a frame: on the first frame
    where JAX inserts a keyframe ("insert": with create_depth_points and
    the BoW vector) and on the last one ("track").  The pose agrees to 1e-4
    (a pose LM over some hundred points summed in another order), the
    keyframe decision exactly, the tracked point-id sets nearly (a match at
    its threshold can flip); an inserted keyframe's observations agree on
    >= 99% of its slots and its new points to 1e-3 m."""
    sensor, jslam, snaps = jax_session
    f = _insertion_frame(snaps) if kind == "insert" else N_JAX - 1
    jst, jts, tst, tts = _carried(snaps[f])
    s, right = seq
    imgs = _images(s, right, sensor, f)
    j_state, j_ts, _, j_hud = jslam._full_step(
        jst, jts, tuple(jnp.asarray(a, jnp.float32) for a in imgs), f,
        s.timestamps[f], jnp.asarray(False))
    step = tsystem.build_full_step(small_cfg(tconfig, sensor), "cpu",
                                   transform)
    t_state, t_ts, _, t_hud = step(
        tst, tts, tuple(torch.from_numpy(a) for a in imgs), f,
        float(s.timestamps[f]))
    j_hud, t_hud = np.asarray(j_hud), t_hud.numpy()
    assert t_hud[HUD_STATUS] == j_hud[HUD_STATUS] == 2
    assert t_hud[HUD_NEED_KF] == j_hud[HUD_NEED_KF] == int(kind == "insert")
    _same_pose(t_ts.T.numpy(), j_ts.T, 1e-4)
    assert _jaccard(t_ts.last_pids.numpy(), j_ts.last_pids) >= 0.95
    assert abs(int(t_state.n_mp) - int(j_state.n_mp)) <= \
        0.02 * int(j_state.n_mp) + 2
    assert int(t_state.next_kf) == int(j_state.next_kf)
    assert int(t_ts.map_stage) == int(j_ts.map_stage)
    assert int(t_ts.map_kf) == int(j_ts.map_kf)
    for fld in ("traj", "T", "velocity", "last_T"):
        np.testing.assert_allclose(getattr(t_ts, fld).numpy(),
                                   np.asarray(getattr(j_ts, fld)), rtol=0,
                                   atol=1e-4, err_msg=fld)
    if kind == "insert":
        k = int(j_ts.ref_kf)
        made_j = int(j_state.next_mp) - int(jst.next_mp)
        made_t = int(t_state.next_mp) - int(tst.next_mp)
        assert made_j > 20 and abs(made_t - made_j) <= 0.02 * made_j + 2
        jo, to = np.asarray(j_state.kf_obs[k]), t_state.kf_obs[k].numpy()
        live = (jo >= 0) | (to >= 0)
        assert (jo == to)[live].mean() >= 0.99
        new = (jo >= int(jst.next_mp)) & (jo == to)
        np.testing.assert_allclose(
            t_state.mp_pos.numpy()[to[new]],
            np.asarray(j_state.mp_pos)[jo[new]], rtol=0, atol=1e-3)
        np.testing.assert_allclose(t_state.kf_bow[k].numpy(),
                                   np.asarray(j_state.kf_bow)[k], rtol=0,
                                   atol=1e-6)


STAGES = {"triangulate": 0, "fuse": 1, "local_ba_chunk": 2, "cull": 5}


@pytest.mark.parametrize("stage", list(STAGES))
def test_mapping_stage_from_carried_state_matches_jax(jax_session, stage):
    """Each keyframe-integration stage on the newest keyframe of JAX's
    state after N_JAX frames: triangulation against 10 neighbours, fusion,
    a local-BA chunk with stereo rows, the culls with the close-point
    filter.  Poses to 1e-4, points to 1e-3 where both hold one (5 LM
    iterations); the observation tables nearly agree."""
    sensor, jslam, snaps = jax_session
    jst, jts, tst, tts = _carried(snaps[-1])
    cfg = small_cfg(tconfig, sensor)
    k, st = int(jst.next_kf) - 1, STAGES[stage]
    assert k >= 2
    j, jts2 = jslam._mapping_stage(jst, jts._replace(
        map_kf=jnp.asarray(k, jnp.int32),
        map_stage=jnp.asarray(st, jnp.int32)))
    t, tts2 = tsystem.mapping_stage(tst, tts._replace(
        map_kf=torch.tensor(k, dtype=torch.int32),
        map_stage=torch.tensor(st, dtype=torch.int32)), cfg)
    assert int(tts2.map_stage) == int(jts2.map_stage)
    assert int(tts2.map_kf) == int(jts2.map_kf)
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
        assert abs(int(t["next_mp"]) - int(j.next_mp)) <= 0.05 * made + 2


def _close_cfg(m, sensor):
    """small_cfg with the close/far threshold at 60 baselines (4.8 m), so
    this scene (depths 2-8 m) has both close and far keypoints; at 35 (2.8
    m) nearly all are far."""
    cfg = small_cfg(m, sensor)
    return cfg.replace(camera=dataclasses.replace(cfg.camera, th_depth=60.0))


def test_create_depth_points_matches_jax(jax_session, seq):
    """A frame inserted with no tracked points, then its depth points: every
    close one and the nearest far ones up to 100 (ranked by a stable sort
    over inf-padded depths).  The same keypoints get points, in the same
    slots, at positions within 1e-4 m (an unprojection and a pose)."""
    sensor, jslam, snaps = jax_session
    jst, jts, tst, tts = _carried(snaps[-1])
    f = N_JAX - 1
    jf = _jax_frame(jslam, seq, sensor, f)
    tf = convert.frame_from_numpy(_fields(jf), device="cpu")
    n = jf.uv.shape[0]
    j, k = jops.insert_keyframe(jst, jf, jts.T, jnp.full((n,), -1, jnp.int32))
    j = jax.jit(jmapping.create_depth_points, static_argnums=2)(
        j, k, _close_cfg(jconfig, sensor))
    cfg = _close_cfg(tconfig, sensor)
    t, tk = tops.insert_keyframe(tst, tf, tts.T,
                                 torch.full((n,), -1, dtype=torch.int32))
    tmapping.depth_points.reset()
    tmapping.close_depth_points.reset()
    t = tmapping.create_depth_points(t, tk, cfg)
    assert tk == int(k)
    d = np.asarray(jf.depth)
    far = (d > 0) & (d >= cfg.camera.th_depth * cfg.camera.baseline)
    close = (d > 0) & ~far
    made = int(j.next_mp) - int(jst.next_mp)
    # both branches: close points, and a far quota that cuts
    quota = cfg.tracking.close_depth_n
    assert 0 < close.sum() < quota < close.sum() + far.sum()
    assert made == quota, (made, close.sum(), far.sum())
    # the module's counts: every point made, and every close one
    assert int(tmapping.depth_points) == made
    assert int(tmapping.close_depth_points) == close.sum()
    assert int(t.next_mp) == int(j.next_mp)
    np.testing.assert_array_equal(t.kf_obs[tk].numpy(),
                                  np.asarray(j.kf_obs[k]))
    np.testing.assert_array_equal(t.mp_valid.numpy(), np.asarray(j.mp_valid))
    np.testing.assert_allclose(t.mp_pos.numpy(), np.asarray(j.mp_pos),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t.covis.numpy(), np.asarray(j.covis))


def test_keyframe_culling_with_close_points_matches_jax(jax_session):
    """`cull_redundant_keyframes` on the newest keyframe, counting only
    each candidate's close points (at the 4.8 m threshold, so some are): the
    same keyframe is culled, or none, and the map agrees."""
    sensor, _, snaps = jax_session
    jst, jts, tst, tts = _carried(snaps[-1])
    k = int(jst.next_kf) - 1
    j, jts2 = jax.jit(jmapping.cull_redundant_keyframes, static_argnums=3)(
        jst, jts, k, _close_cfg(jconfig, sensor))
    t, tts2 = tmapping.cull_redundant_keyframes(tst, tts, k,
                                                _close_cfg(tconfig, sensor))
    np.testing.assert_array_equal(t.kf_valid.numpy(), np.asarray(j.kf_valid))
    np.testing.assert_array_equal(t.kf_parent.numpy(),
                                  np.asarray(j.kf_parent))
    np.testing.assert_array_equal(t.mp_valid.numpy(), np.asarray(j.mp_valid))
    np.testing.assert_allclose(tts2.traj.numpy(), np.asarray(jts2.traj),
                               rtol=0, atol=1e-5)
    d = np.asarray(jst.kf_depth)[:k + 1]
    assert ((d > 0) & (d < 4.8)).any(axis=1).sum() >= 2


# ---------------------------------------------------------------------------
# (c) the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SENSORS))
def test_port_run_tracks_under_the_e2e_gate(seq, name):
    """A 30-frame port session on the CPU: >= 90% of frames tracked, metric
    ATE (no scale alignment) under test_e2e's gate for the sensor, and BoW
    on every keyframe."""
    sensor = SENSORS[name]
    s, right = seq
    slam = tsystem.SLAM(small_cfg(tconfig, sensor), device="cpu")
    track = slam.track_stereo if sensor == STEREO else slam.track_rgbd
    for f in range(N_RUN):
        track(*_images(s, right, sensor, f), s.timestamps[f])
    slam.flush()
    est = slam.poses_twc()
    ie, ig = evaluate.match_timestamps(slam.timestamps(), s.timestamps)
    assert len(ie) >= 0.9 * N_RUN, len(ie)
    ate = evaluate.ate_rmse(est[ie], s.poses_twc[ig], align_scale=False)
    assert ate <= ATE_GATE[sensor], ate
    kv = slam.state.kf_valid
    assert int(kv.sum()) >= 2
    assert bool((slam.state.kf_bow[kv].abs().sum(1) > 0.99).all())
    with pytest.raises(ValueError, match="sensor"):
        slam.track_mono(s.images[0], 99.0)


@pytest.mark.parametrize("name", list(SENSORS))
def test_slam_runs_on_cuda_by_default(name):
    cfg = small_cfg(tconfig, SENSORS[name])
    if torch.cuda.is_available():
        assert tsystem.SLAM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsystem.SLAM(cfg)
