"""The port's data-parallel multi-sequence step (`distributed/dp.py`)
against the JAX package's `build_dp_step`, on the CPU.

Configuration: scripts/dp_slam_bench.py's `small_rgbd_cfg` (320x240, 500
features, bf 16), copied.  Input: the JAX renderer's xyz sequences of
seeds 0 and 1, N_FRAMES frames each.  The JAX side runs its `init_fn` and
`step_fn` jitted, one sequence at a time: a vmapped S = 2 program takes
~15 s longer to compile cold (63 s against 48 s on the CPU this was
written on) and gives the same trajectories to 2.5e-6.  The port runs the
two sequences as one S = 2 batch.  JAX compiles in a background thread
(XLA's compiler releases the GIL) while the port's runs go ahead, so the
tests that need JAX's results come last.

Tracking runs once over the S sequences (`tracking.build_track_step` on
the stacked state): a mixed batch of S = 3 (one sequence with no
velocity, one whose motion model fails and falls back to the reference
keyframe, one tracked by the motion model) gives each sequence exactly the
bits of its S = 1 call and the same per-sequence counts, and each row is
held to JAX's unbatched track step (jitted after JAX's dp step, in the
same background thread) from JAX's dp states, to 1e-4 in the pose, as
tests/test_torch_session.py holds one step from the same state.

Keyframe insertion and the integration stages run once over the
sequences too: a mixed S = 5 batch of dp-step inputs made from the S = 2
run's snapshots (a sequence inserting, one in a BA chunk, one idle, two
triangulating, one of them with its keyframe deferred) gives each
sequence the bits of its S = 1 step, in warm-up mode as well, with the
insertion and each stage group one batched call.

The rewritten step makes every decision a device branch and writes into
the stacked state in place: the S = 2 run goes under test_torch_graph's
`HostReads` (0 reads but the helpers' marked predicate reads, over
insertions and every stage but the cull; its last step, in warm-up mode,
runs every branch, the cull's too), every stacked field keeps its
storage, and each sequence alone runs through `DPProgram` (eager on the
CPU, no warm-up step), so the batch is also held to the program.

Tolerances: the tracking status, the keyframe decision and the keyframe
count exactly, inlier and map-point counts within 2% + 2, as in
tests/test_torch_stereo.py's fused-step checks.  Trajectory rows within
1e-3, as tests/test_torch_session.py holds a multi-frame run: one step
from the same state agrees to 1e-4 there, but here each frame starts
from the previous frame's pose and map, and a weak frame (129 inliers at
frame 6 of seed 1) turns that round-off into 2.6e-4 on both JAX
variants (vmapped and per-sequence agree to 2.5e-6).
"""

import contextlib
import datetime
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.core import lie as jlie
from orb_slam2_tpu.distributed import dp as jdp
from orb_slam2_tpu.io import synthetic
from orb_slam2_tpu.map import empty_map as jempty_map
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import tracking as jtracking
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.distributed import dp as tdp
from orb_slam2_tpu_torch.distributed.launch import free_port
from orb_slam2_tpu_torch.map.state import empty_map as tempty_map
from orb_slam2_tpu_torch.core import control
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import mapping as tmapping
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline import tracking as ttracking
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_N_INLIERS, HUD_N_KF,
                                                   HUD_N_MP, HUD_NEED_KF,
                                                   HUD_STATUS,
                                                   empty_track_state)
from test_torch_graph import HostReads

S = 2
N_FRAMES = 8
N_STAGES_RUN = tdp.N_STAGES - 1     # every stage but the cull
TRAJ_TOL = 1e-3
POSE_TOL = 1e-4                     # one track step from the same state
# the counts the batched track must give as its S = 1 calls do, summed
SEQ_COUNTS = ("ref_kf_fallbacks", "need_close_frames", "vo_candidates",
              "vo_inliers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; the port's
    small tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_rgbd_cfg(m):
    """scripts/dp_slam_bench.py:31-42 for package config module m."""
    cam = m.CameraConfig(
        fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240,
        fps=30.0, bf=16.0, th_depth=35.0)
    orb = m.ORBConfig(n_features=500, max_keypoints=512)
    cap = m.Capacity(
        max_keyframes=96, max_points=6144, max_obs_per_kf=512,
        max_frames=512, local_ba_points=2048)
    return m.SLAMConfig(sensor=m.RGBD, camera=cam, orb=orb, cap=cap)


@pytest.fixture(scope="module")
def batch():
    """(images [S, F, H, W], depths, timestamps [S, F]) f32, F = N_FRAMES
    and one more frame for the profiled step."""
    cam = small_rgbd_cfg(jconfig).camera
    seqs = [synthetic.generate(cam, n_frames=N_FRAMES + 1, n_points=300,
                               trajectory="xyz", seed=s) for s in range(S)]
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32([q.images for q in seqs]), f32([q.depths for q in seqs]),
            f32([q.timestamps for q in seqs]))


def _port_run(batch, seqs, record=None):
    """The port's dp step over the sequences `seqs` as one batch: (state,
    ts, hud [S, F-1, 5]).  With a dict `record`, the steps run under
    `HostReads` (record["reads"]), the last one in warm-up mode (every
    branch run, the chosen one's result returned), and record the stage
    each step ran (an insertion's step runs stage 0), the stacked fields'
    storage before and after, and a copy of the stacked state before each
    step (record["snaps"][f - 1] before step f)."""
    imgs, depths, ts_ = (torch.from_numpy(a[seqs]) for a in batch)
    init_fn, step_fn = tdp.build_dp_step(small_rgbd_cfg(tconfig), "cpu")
    state, ts = tdp.make_batch_states(small_rgbd_cfg(tconfig), len(seqs),
                                      "cpu")
    ptrs = [x.data_ptr() for x in state + ts]
    state, ts = init_fn(state, ts, imgs[:, 0], depths[:, 0])
    huds = []
    for f in range(1, N_FRAMES):
        fid = torch.full((len(seqs),), f, dtype=torch.int32)
        if record is None:
            state, ts, hud = step_fn(state, ts, imgs[:, f], depths[:, f],
                                     fid, ts_[:, f])
        else:
            record["snaps"].append((tsystem.clone(state), tsystem.clone(ts)))
            kf0 = state.next_kf.clone()
            stage = torch.where(ts.map_kf >= 0, ts.map_stage, -1)
            warm = control.warmup() if f == N_FRAMES - 1 else \
                contextlib.nullcontext()
            with record["reads"], warm:
                state, ts, hud = step_fn(state, ts, imgs[:, f],
                                         depths[:, f], fid, ts_[:, f])
            stage = torch.where(state.next_kf > kf0, 0, stage)
            record["stages"].update(int(x) for x in stage)
        huds.append(hud)
    if record is not None:
        record["ptrs"] = (ptrs, [x.data_ptr() for x in state + ts])
    return state, ts, torch.stack(huds, 1).numpy()


@pytest.fixture(scope="module")
def port_record():
    return dict(reads=HostReads(), stages=set(), snaps=[])


@pytest.fixture(scope="module")
def port(batch, port_record):
    return _port_run(batch, [0, 1], port_record)


def _compile_jax():
    """JAX's dp init and step, jitted and compiled for one sequence."""
    cfg = small_rgbd_cfg(jconfig)
    init_fn, step_fn = jdp.build_dp_step(cfg)
    st, ts = jempty_map(cfg), jtracking.empty_track_state(cfg)
    img = jnp.zeros((cfg.camera.height, cfg.camera.width), jnp.float32)
    return (jax.jit(init_fn).lower(st, ts, img, img).compile(),
            jax.jit(step_fn).lower(st, ts, img, img, jnp.int32(0),
                                   jnp.float32(0.0)).compile())


def _compile_jax_track():
    """JAX's track step, jitted and compiled for one sequence."""
    cfg = small_rgbd_cfg(jconfig)
    fr = tsystem.empty_frames(small_rgbd_cfg(tconfig), 1, "cpu")
    fr = jframe.Frame(*(jnp.asarray(x[0].numpy()) for x in fr))
    return jax.jit(jtracking.build_track_step(cfg)).lower(
        jempty_map(cfg), jtracking.empty_track_state(cfg), fr).compile()


@pytest.fixture(autouse=True, scope="module")
def jax_compiled():
    """Futures of `_compile_jax()` and `_compile_jax_track()`, started
    before the module's first test, one after the other in one thread
    (~38 s and ~12 s on the CPU: together still shorter than the port's
    runs before the first test that needs them)."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_compile_jax), ex.submit(_compile_jax_track)


@pytest.fixture(scope="module")
def jax_runs(batch, jax_compiled):
    """JAX's dp init and step, jitted, per sequence: [(state, ts, huds)]."""
    cfg = small_rgbd_cfg(jconfig)
    init_fn, step_fn = jax_compiled[0].result()
    imgs, depths, ts_ = batch
    out = []
    for s in range(S):
        st, ts = init_fn(jempty_map(cfg), jtracking.empty_track_state(cfg),
                         jnp.asarray(imgs[s, 0]), jnp.asarray(depths[s, 0]))
        huds = []
        for f in range(1, N_FRAMES):
            st, ts, hud = step_fn(st, ts, jnp.asarray(imgs[s, f]),
                                  jnp.asarray(depths[s, f]), jnp.int32(f),
                                  jnp.float32(ts_[s, f]))
            huds.append(np.asarray(hud))
        out.append((st, ts, np.stack(huds)))
    return out


def test_rgbd_frame_fn_over_s_images_equals_one_image(batch):
    """One S-image call (one atlas program over S·L planes) gives, per
    image, the one-image function's Frame bit for bit."""
    cfg = small_rgbd_cfg(tconfig)
    imgs, depths, ts_ = (torch.from_numpy(a) for a in batch)
    f = 3
    many = tframe.build_rgbd_frame_fn(cfg, "cpu", n_images=S)(
        imgs[:, f], depths[:, f], torch.full((S,), f), ts_[:, f])
    one = tframe.build_rgbd_frame_fn(cfg, "cpu")
    for s in range(S):
        single = one(imgs[s, f], depths[s, f], f, ts_[s, f])
        assert int(single.n) > 400
        for name, a, b in zip(single._fields, single, many):
            assert torch.equal(a, b[s]), name


@pytest.mark.parametrize("s", range(S))
def test_s2_batch_equals_each_sequence_alone(batch, port, s):
    """The S = 2 batch gives sequence s exactly what it gets alone
    (S = 1, through `DPProgram`, eager on the CPU): no write-back of one
    sequence reaches another."""
    tst, tts, thud = port
    imgs, depths, ts_ = (torch.from_numpy(a[[s]]) for a in batch)
    prog = tdp.DPProgram(small_rgbd_cfg(tconfig), 1, "cpu")
    assert not prog.capture
    prog.init(imgs[:, 0], depths[:, 0])
    for f in range(1, N_FRAMES):
        prog.step(imgs[:, f], depths[:, f], f, ts_[:, f])
    assert prog.steps == N_FRAMES - 1 and prog.graph_replays == 0
    ost, ots, ohud = prog.state, prog.ts, prog.huds().transpose(1, 0, 2)
    np.testing.assert_array_equal(thud[s], ohud[0])
    for a, b in ((tst, ost), (tts, ots)):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x[s], y[0]), f


def test_dp_step_makes_no_host_read(port, port_record):
    """The S = 2 run's steps (insertions, every stage but the cull, which
    the second keyframe aborts; the last step in warm-up mode, which runs
    every branch: the motion model's fallback, each stage, the keyframe
    cull) make no host read but the helpers' marked predicate reads, and
    write into the stacked state's own storage.  (The warm-up step's
    results are the step's: the batch equals each sequence run alone
    without it, test_s2_batch_equals_each_sequence_alone.)"""
    rec = port_record
    assert set(range(N_STAGES_RUN)) <= rec["stages"], rec["stages"]
    assert rec["reads"].n == 0, rec["reads"].where
    before, after = rec["ptrs"]
    assert before == after
    assert (port[2][:, :, HUD_STATUS] == 2).all()


def test_dp_requires_rgbd():
    cfg = small_rgbd_cfg(tconfig)
    with pytest.raises(ValueError, match="RGB-D"):
        tdp.build_dp_step(tconfig.SLAMConfig(camera=cfg.camera), "cpu")


@pytest.fixture
def one_rank_group():
    """This process as a 1-rank gloo group."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_sharded_step_issues_no_collective(batch, port, one_rank_group):
    """A profiled step of `build_sharded_step` on the rank's shard
    (`shard_batch`) shows no collective, while an all-reduce in the same
    kind of trace is counted."""
    g = one_rank_group
    cfg = small_rgbd_cfg(tconfig)
    tst, tts, _ = port
    state, ts = tdp.shard_batch((tst, tts), g)
    imgs, depths, ts_ = (tdp.shard_batch(torch.from_numpy(a), g)
                         for a in batch)
    assert state.kf_pose.shape[0] == S
    init_fn, step_fn = tdp.build_sharded_step(cfg, g, "cpu")
    f = N_FRAMES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, hud = step_fn(state, ts, imgs[:, f], depths[:, f],
                            torch.full((S,), f, dtype=torch.int32), ts_[:, f])
    assert (hud[:, HUD_STATUS] == 2).all()
    assert tdp.collective_ops_in_trace(prof) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dist.all_reduce(torch.ones(3), group=g)
    assert tdp.collective_ops_in_trace(prof) >= 1


def test_make_batch_states_matches_jax():
    """S stacked fresh states: JAX's shapes and dtypes (traced, not run),
    every slot the one-sequence state (held against JAX's in
    tests/test_torch_map.py)."""
    jst, jts = jax.eval_shape(
        lambda: jdp.make_batch_states(small_rgbd_cfg(jconfig), 3))
    cfg = small_rgbd_cfg(tconfig)
    tst, tts = tdp.make_batch_states(cfg, 3, "cpu")
    one = (tempty_map(cfg, "cpu"), empty_track_state(cfg, "cpu"))
    for j, t, o in ((jst, tst, one[0]), (jts, tts, one[1])):
        for f, a, b, c in zip(t._fields, j, t, o):
            assert tuple(a.shape) == tuple(b.shape), f
            assert np.dtype(a.dtype) == convert.to_numpy(t)[f].dtype, f
            for s in range(3):
                assert torch.equal(b[s], c), f


@pytest.mark.parametrize("s", range(S))
def test_dp_step_matches_jax(port, jax_runs, s):
    """Sequence s of the port's S = 2 run against JAX's init and step on
    that sequence: every frame tracked by both, the same keyframes."""
    tst, tts, thud = port
    jst, jts, jhud = jax_runs[s]
    assert int(jnp.sum(jst.kf_valid)) >= 2, "JAX made no keyframe"
    th = thud[s]
    assert (jhud[:, HUD_STATUS] == 2).all()
    for col in (HUD_STATUS, HUD_NEED_KF, HUD_N_KF):
        np.testing.assert_array_equal(th[:, col], jhud[:, col])
    for col in (HUD_N_INLIERS, HUD_N_MP):
        assert (np.abs(th[:, col] - jhud[:, col]) <=
                0.02 * jhud[:, col] + 2).all(), col
    np.testing.assert_allclose(tts.traj[s, :N_FRAMES].numpy(),
                               np.asarray(jts.traj)[:N_FRAMES], rtol=0,
                               atol=TRAJ_TOL)
    assert int(tst.kf_valid[s].sum()) == int(jnp.sum(jst.kf_valid))
    j_mp = int(jnp.sum(jst.mp_valid))
    assert abs(int(tst.mp_valid[s].sum()) - j_mp) <= 0.02 * j_mp + 2
    assert int(tts.map_stage[s]) == int(jts.map_stage)
    assert int(tts.map_kf[s]) == int(jts.map_kf)


def test_trajectories_match_jax_session_export(port, jax_runs):
    """`trajectories`, per sequence, against the JAX session's export
    formula (system.py:568-578: Tcr x the reference keyframe's pose,
    inverted) on JAX's dp state: the same frames and timestamps, camera
    centres within the trajectory tolerance."""
    tst, tts, _ = port
    for s, (t, twc) in enumerate(tdp.trajectories(tst, tts, N_FRAMES)):
        jst, jts, _ = jax_runs[s]
        traj = jts.traj[:N_FRAMES]
        ref = jnp.clip(traj[:, 14].astype(jnp.int32), 0, None)
        jtwc = jax.vmap(jlie.se3_inverse)(jax.vmap(jlie.se3_compose)(
            traj[:, 7:14], jst.kf_pose[ref]))
        ok = np.asarray((traj[:, 15] > 0.5) & (traj[:, 14] >= 0))
        np.testing.assert_array_equal(t, np.asarray(traj[:, 16])[ok])
        np.testing.assert_allclose(twc[:, 4:7], np.asarray(jtwc)[ok, 4:7],
                                   rtol=0, atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# tracking over the sequence axis
# ---------------------------------------------------------------------------

MIXED = ("motion model", "no velocity", "motion model fails")


@pytest.fixture(scope="module")
def mixed(batch, jax_runs):
    """S = 3 (JAX state, JAX track state, port Frame) triples from JAX's dp
    states after frame N_FRAMES - 1, and frame N_FRAMES: sequence 0 as it
    is (tracked by the motion model), sequence 1 with no velocity (the
    reference keyframe), sequence 0 with a velocity that turns the camera
    round (its motion model finds nothing: the fallback)."""
    cfg = small_rgbd_cfg(tconfig)
    imgs, depths, ts_ = (torch.from_numpy(a) for a in batch)
    fn = tframe.build_rgbd_frame_fn(cfg, "cpu")
    f = N_FRAMES
    out = []
    for s, case in zip((0, 1, 0), MIXED):
        jst, jts, _ = jax_runs[s]
        if case == "no velocity":
            jts = jts._replace(has_velocity=jnp.asarray(False))
        elif case == "motion model fails":
            jts = jts._replace(velocity=jnp.asarray(
                [0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32))
        out.append((jst, jts, fn(imgs[s, f], depths[s, f], f, ts_[s, f])))
    return out


def _stack(trees):
    return type(trees[0])(*(torch.stack(x) for x in zip(*trees)))


def _track_counts():
    return {k: int(getattr(ttracking, k)) for k in SEQ_COUNTS +
            ("motion_model_steps", "ref_kf_steps")}


def _reset_counts():
    for k in SEQ_COUNTS + ("motion_model_steps", "ref_kf_steps"):
        getattr(ttracking, k).reset()


def _carried(jst, jts):
    to_np = lambda nt: {f: np.array(v) for f, v in zip(nt._fields, nt)}
    return (convert.map_state_from_numpy(to_np(jst), device="cpu"),
            convert.track_state_from_numpy(to_np(jts), device="cpu"))


@pytest.fixture(scope="module")
def batched_track(mixed):
    """The port's track over the S = 3 mixed batch, and each sequence's
    S = 1 call on the same state: (batched out, counts; [S = 1 outs],
    summed counts)."""
    track = ttracking.build_track_step(small_rgbd_cfg(tconfig))
    carried = [_carried(jst, jts) + (fr,) for jst, jts, fr in mixed]
    _reset_counts()
    many = track(*(_stack(list(x)) for x in zip(*carried)))
    many_counts = _track_counts()
    ones = []
    _reset_counts()
    for st, ts, fr in carried:
        one = lambda t: type(t)(*(x[None] for x in t))
        ones.append(track(one(st), one(ts), one(fr)))
    return many, many_counts, ones, _track_counts()


def test_batched_track_equals_each_sequence_alone(batched_track):
    """One track call over the mixed S = 3 batch gives each sequence the
    bits of its S = 1 call, and the per-sequence counts their sum: one
    fallback; the motion model and the reference-keyframe match each ran
    once for the batch, twice over the three single calls."""
    many, mc, ones, oc = batched_track
    (mst, mts, mpids, mhud) = many
    for s, (ost, ots, opids, ohud) in enumerate(ones):
        assert torch.equal(mpids[s], opids[0]), s
        assert torch.equal(mhud[s], ohud[0]), s
        for a, b in ((mst, ost), (mts, ots)):
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x[s], y[0]), (s, f)
    assert {k: mc[k] for k in SEQ_COUNTS} == {k: oc[k] for k in SEQ_COUNTS}
    assert mc["ref_kf_fallbacks"] == 1
    assert (mc["motion_model_steps"], mc["ref_kf_steps"]) == (1, 1)
    assert (oc["motion_model_steps"], oc["ref_kf_steps"]) == (2, 2)
    assert (mhud[:, HUD_STATUS] == 2).all()


@pytest.mark.parametrize("s", range(len(MIXED)))
def test_batched_track_matches_jax(mixed, batched_track, jax_compiled, s):
    """Row s of the batched track against JAX's track step on that
    sequence alone (jitted, from the same state and frame): status,
    keyframe decision and counts exactly, inliers within 2% + 2, the pose
    within POSE_TOL, the tracked point ids nearly the same."""
    jst, jts, fr = mixed[s]
    jfr = jframe.Frame(*(jnp.asarray(x.numpy()) for x in fr))
    j_state, j_ts, j_pids, j_hud = jax_compiled[1].result()(jst, jts, jfr)
    (mst, mts, mpids, mhud) = batched_track[0]
    j_hud, t_hud = np.asarray(j_hud), mhud[s].numpy()
    for col in (HUD_STATUS, HUD_NEED_KF, HUD_N_KF, HUD_N_MP):
        assert t_hud[col] == j_hud[col], (MIXED[s], col)
    assert abs(int(t_hud[HUD_N_INLIERS]) - int(j_hud[HUD_N_INLIERS])) <= \
        0.02 * int(j_hud[HUD_N_INLIERS]) + 2
    a = mts.T[s].numpy().astype(np.float64)
    b = np.asarray(j_ts.T, np.float64)
    if np.dot(a[:4], b[:4]) < 0:
        a[:4] = -a[:4]
    np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
    t_ids = set(mpids[s][mpids[s] >= 0].tolist())
    j_ids = set(np.asarray(j_pids)[np.asarray(j_pids) >= 0].tolist())
    assert len(t_ids & j_ids) >= 0.98 * len(t_ids | j_ids), MIXED[s]
    assert bool(mts.has_velocity[s]) and bool(j_ts.has_velocity)


# ---------------------------------------------------------------------------
# keyframe insertion and the integration stages over the sequence axis
# ---------------------------------------------------------------------------

# the counts the batched insertion and stages must give as their S = 1
# calls do, summed
STAGE_SEQ_COUNTS = ("depth_points", "close_depth_points")
MIXED_STAGES = ("inserts", "idle", "BA chunk", "triangulates, defers",
                "triangulates")


def _stage_counts():
    out = {k: int(getattr(tmapping, k)) for k in STAGE_SEQ_COUNTS}
    out["insert_calls"] = int(tsystem.insert_calls)
    out.update({g: int(c) for g, c in tsystem.stage_calls.items()})
    out.update(_track_counts())
    return out


def _reset_stage_counts():
    for k in STAGE_SEQ_COUNTS:
        getattr(tmapping, k).reset()
    tsystem.insert_calls.reset()
    for c in tsystem.stage_calls.values():
        c.reset()
    _reset_counts()


@pytest.fixture(scope="module")
def mixed_stage(batch, port, port_record):
    """An S = 5 batch of dp-step inputs from the S = 2 run's snapshots,
    one sequence in each of MIXED_STAGES: (state, ts) before a step where
    sequence 0 needs a keyframe and inserts it (then triangulates it); one
    idle (map_kf = -1); one where sequence 1 needs none, put in a BA chunk
    of its newest keyframe; the first one's again, put at stage 0 of its
    newest keyframe, so that its keyframe waits (busy_early) while it
    triangulates; the BA one's, put at stage 0 too.  Three sequences
    triangulate: a batch of four of the five, the idle one gathered only
    to fill it (`system.on_sequences`; triangulating its keyframe 0 would
    make points).  Returns [(state, ts, img, depth, fid, t)] with S = 1
    fields."""
    hud = port[2]
    snaps = port_record["snaps"]
    imgs, depths, stamps = (torch.from_numpy(a) for a in batch)
    busy = lambda f, s: bool((snaps[f - 1][1].map_kf[s] >= 0) &
                             (snaps[f - 1][1].map_stage[s] <= 1))
    need = lambda f, s: bool(hud[s, f - 1, HUD_NEED_KF])
    steps = range(1, N_FRAMES)
    f_ins = max(f for f in steps if need(f, 0) and not busy(f, 0))
    f_ba = max(f for f in steps if not need(f, 1))
    f_idle = max(f for f in steps if not need(f, 0))

    def member(f, s, **patch):
        st, tt = (type(x)(*(v[s:s + 1].clone() for v in x))
                  for x in snaps[f - 1])
        newest = (st.next_kf - 1).to(torch.int32)
        patch = {k: (newest if v == "newest" else torch.full_like(
            getattr(tt, k), v)) for k, v in patch.items()}
        return (st, tt._replace(**patch), imgs[s:s + 1, f],
                depths[s:s + 1, f], torch.full((1,), f, dtype=torch.int32),
                stamps[s:s + 1, f])

    return [member(f_ins, 0),
            member(f_idle, 0, map_kf=-1, map_stage=0),
            member(f_ba, 1, map_kf="newest", map_stage=3),
            member(f_ins, 0, map_kf="newest", map_stage=0),
            member(f_ba, 1, map_kf="newest", map_stage=0)]


@pytest.fixture(scope="module")
def batched_stage(mixed_stage):
    """One dp step over the S = 5 mixed batch, the same step in warm-up
    mode (every branch run: the keyframe cull too), and each member's
    S = 1 step: (batched out, counts; warm-up out; [S = 1 outs], summed
    counts)."""
    _, step_fn = tdp.build_dp_step(small_rgbd_cfg(tconfig), "cpu")
    cat = lambda *xs: type(xs[0])(*(torch.cat(v) for v in zip(*xs))) \
        if isinstance(xs[0], tuple) else torch.cat(xs)
    stacked = [cat(*x) for x in zip(*mixed_stage)]
    fresh = lambda args: [tsystem.clone(a) if isinstance(a, tuple)
                          else a.clone() for a in args]
    _reset_stage_counts()
    many = step_fn(*fresh(stacked))
    many_counts = _stage_counts()
    with control.warmup():
        warm = step_fn(*fresh(stacked))
    _reset_stage_counts()
    ones = [step_fn(*fresh(m)) for m in mixed_stage]
    return many, many_counts, warm, ones, _stage_counts()


@pytest.mark.parametrize("s", range(len(MIXED_STAGES)))
def test_batched_insertion_and_stages_equal_each_sequence_alone(
        batched_stage, s):
    """One dp step over the mixed S = 5 batch (a sequence inserting and
    triangulating, one idle, one in a BA chunk, one triangulating with its
    keyframe deferred, one triangulating) gives sequence s the bits of its
    S = 1 step, every state field and HUD."""
    many, _, _, ones, _ = batched_stage
    for part, a, b in zip(("state", "ts", "hud"), many, ones[s]):
        pairs = zip(a._fields, a, b) if isinstance(a, tuple) else \
            [("", a, b)]
        for f, x, y in pairs:
            assert torch.equal(x[s], y[0]), (MIXED_STAGES[s], part, f)


def test_batched_insertion_and_stages_run_once_for_the_batch(
        mixed_stage, batched_stage):
    """The mixed S = 5 step takes each sequence's own path (inserted and
    triangulated; idle; a BA chunk; triangulated with its keyframe
    deferred; triangulated), the same step in warm-up mode (every branch,
    every batch size, the keyframe cull's too) gives the same bits, the
    per-sequence counts are the single steps' sum, and the insertion and
    each stage group run once for the batch: the triangulation once for
    three sequences."""
    many, mc, warm, ones, oc = batched_stage
    for part, a, b in zip(("state", "ts", "hud"), many, warm):
        pairs = zip(a._fields, a, b) if isinstance(a, tuple) else \
            [("", a, b)]
        for f, x, y in pairs:
            assert torch.equal(x, y), ("warm-up", part, f)
    before = [m[1] for m in mixed_stage]
    after = many[1]
    assert int(after.map_kf[0]) == int(mixed_stage[0][0].next_kf[0])
    assert int(after.map_stage[0]) == 1                  # inserted, tri ran
    assert int(after.map_kf[1]) == -1                    # idle
    assert int(after.map_stage[2]) == 4                  # a BA chunk ran
    assert int(after.map_kf[3]) == int(before[3].map_kf[0])   # deferred
    assert int(after.map_stage[3]) == 1
    assert int(after.map_stage[4]) == 1                  # tri ran
    assert many[2][3, HUD_NEED_KF] == 1
    assert {k: mc[k] for k in STAGE_SEQ_COUNTS + SEQ_COUNTS} == \
        {k: oc[k] for k in STAGE_SEQ_COUNTS + SEQ_COUNTS}
    assert mc["depth_points"] > 0
    assert (mc["insert_calls"], oc["insert_calls"]) == (1, 1)
    assert (mc["triangulate"], oc["triangulate"]) == (1, 3)
    assert (mc["local_ba"], oc["local_ba"]) == (1, 1)
    assert mc["fuse"] == mc["cull"] == oc["fuse"] == oc["cull"] == 0
