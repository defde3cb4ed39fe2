"""The one-program frame step of the port, on the CPU, on tests/test_e2e.py's
small configuration (320x240).

(a) `core.control.cond` against `lax.cond` on a few small functions,
    eagerly and in warm-up mode (every branch run).
(b) Zero host reads in the per-frame step: a `TorchDispatchMode` counts
    the operations that read the device from the host (`item` and its
    kin, `nonzero`, `bincount`, `unique*`, `masked_select`, indexing with a
    boolean mask, `repeat_interleave` with tensor repeats, copies to the
    CPU), leaving out the control helpers' own marked predicate reads, and
    the tensors made from host data (on the card a host-to-device copy,
    which a capture refuses).
    Mono and RGB-D sessions run the eager program under it over their
    insertion frames and the integration stages after them (every stage
    runs), frames tracked against the reference keyframe (no velocity),
    localisation-mode frames, and one step in warm-up mode, which runs
    every branch (the keyframe cull's too): 0 reads.  (On the card the
    same path is held to no sync at all by `set_sync_debug_mode("error")`
    in `chip_smoke.py` phase 20 and `tests/test_torch_cuda.py`.)
(c) The frame ring: relocalisation after a LOST frame gets that frame (its
    frame id), with frame_batch 1 and 4.
(d) Fixed buffers: after `reset`, `load_map`, a relocalisation and a loop
    correction with a chunk of its global BA, every MapState and
    TrackState field keeps its storage.
"""

import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch.core import control
from orb_slam2_tpu_torch.io import synthetic
from orb_slam2_tpu_torch.pipeline import loopclosing as tloop
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline.tracking import LOST, OK

A = torch.ops.aten
READ_OPS = {A._local_scalar_dense.default, A.nonzero.default,
            A.bincount.default, A.masked_select.default, A._unique.default,
            A._unique2.default, A.unique_dim.default,
            A.unique_consecutive.default, A.repeat_interleave.Tensor,
            A.repeat_interleave.self_Tensor,
            # a tensor made from host data (torch.tensor, new_tensor, a
            # Python scalar set by index): on the card a host-to-device
            # copy, which a capture refuses
            A.lift_fresh.default}
INDEX_OPS = {A.index.Tensor, A.index_put.default, A.index_put_.default,
             A._index_put_impl_.default}
WATCHED = READ_OPS | INDEX_OPS | {A._to_copy.default, A.copy_.default}


class HostReads(TorchDispatchMode):
    """Counts the operations of a region that read the device from the
    host; `where` keeps the first few, with the port's frames that made
    them."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.where = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in WATCHED:
            return func(*args, **kwargs)
        hit = func in READ_OPS and not (
            func is A._local_scalar_dense.default and
            control.in_predicate_read())
        if func in INDEX_OPS:
            hit = any(isinstance(i, torch.Tensor) and
                      i.dtype in (torch.bool, torch.uint8)
                      for i in args[1] if i is not None)
        if func in (A._to_copy.default, A.copy_.default):
            src = args[1] if func is A.copy_.default else args[0]
            dst = args[0].device if func is A.copy_.default else \
                kwargs.get("device", src.device)
            hit = src.device.type != "cpu" and \
                torch.device(dst).type == "cpu"
        if hit:
            self.n += 1
            if len(self.where) < 5:
                here = [f"{os.path.basename(f.filename)}:{f.lineno}"
                        for f in traceback.extract_stack()
                        if "orb_slam2_tpu_torch" in f.filename]
                self.where.append((str(func), here[-3:]))
        return func(*args, **kwargs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(sensor=tconfig.MONOCULAR, frame_batch=1):
    """tests/test_e2e.py's small_cfg(sensor)."""
    cam = tconfig.CameraConfig(
        fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240,
        fps=30.0, bf=16.0 if sensor != tconfig.MONOCULAR else 0.0,
        th_depth=35.0)
    return tconfig.SLAMConfig(
        sensor=sensor, camera=cam,
        orb=tconfig.ORBConfig(n_features=500, max_keypoints=512),
        cap=tconfig.Capacity(max_keyframes=96, max_points=6144,
                             max_obs_per_kf=512, max_frames=512,
                             local_ba_points=2048),
        frame_batch=frame_batch)


@pytest.fixture(scope="module")
def seq():
    cam = small_cfg().camera
    return synthetic.generate(cam, n_frames=24, n_points=300,
                              trajectory="xyz", seed=0)


def _feed(slam, seq, frames):
    for f in frames:
        if slam.cfg.sensor == tconfig.RGBD:
            slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])
        else:
            slam.track_mono(seq.images[f], seq.timestamps[f])


def _counted_session(cfg, seq, n_frames, n_loc):
    """A session over frames [0, n_frames) whose program runs under
    HostReads, the last `n_loc` of them in localisation mode; records the
    integration stage each program ran and whether its frame was tracked
    against the reference keyframe (no velocity yet)."""
    slam = tsystem.SLAM(cfg, device="cpu")
    reads = HostReads()
    seen = dict(stages=set(), inserted=0, fallback=0, loc=0)
    run = slam._run_program

    def counted(loc_only):
        stage = int(slam.ts.map_stage) if int(slam.ts.map_kf) >= 0 else -1
        had_vel = bool(slam.ts.has_velocity)
        kf0 = int(slam.state.next_kf)
        with reads:
            run(loc_only)
        inserted = int(slam.state.next_kf) > kf0
        # the stage this program ran: an insertion's step runs stage 0
        seen["stages"].add(0 if inserted else stage)
        seen["inserted"] += inserted
        seen["loc"] += loc_only
        seen["fallback"] += (not had_vel)

    slam._run_program = counted
    _feed(slam, seq, range(n_frames - n_loc))
    slam.activate_localization_mode()
    _feed(slam, seq, range(n_frames - n_loc, n_frames))
    slam.flush()
    # one more frame with every branch run: warm-up mode
    slam.deactivate_localization_mode()
    slam._run_program = run
    imgs = (torch.from_numpy(seq.images[n_frames]),) + (
        (torch.from_numpy(seq.depths[n_frames]),)
        if cfg.sensor == tconfig.RGBD else ())
    fid = torch.tensor(n_frames, dtype=torch.int32)
    t = torch.tensor(float(seq.timestamps[n_frames]))
    warm = HostReads()
    with warm, control.warmup():
        slam._full_step(slam.state, slam.ts, imgs, fid, t)
    return slam, reads, warm, seen


# mono inserts at frame 4 and RGB-D at frame 3 (after initialising at
# frames 1 and 0); the stages run over the 5 frames after an insertion
# (RGB-D inserts again at frame 8, which aborts the first keyframe's cull
# stage: its cull runs in the warm-up step)
@pytest.fixture(scope="module")
def mono(seq):
    return _counted_session(small_cfg(), seq, 12, 2)


@pytest.fixture(scope="module")
def rgbd(seq):
    return _counted_session(small_cfg(tconfig.RGBD), seq, 10, 2)


# ---------------------------------------------------------------------------
# (a) the control helper against lax
# ---------------------------------------------------------------------------

def _branches(m):
    """Two branches of (x, y) for the array module m."""
    return [lambda x, y: (x + y, x * 2.0),
            lambda x, y: (m.sin(x) * y, m.cos(y))]


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("pred", [False, True])
def test_cond_matches_lax_cond(pred, warm):
    x = np.linspace(-1, 1, 5).astype(np.float32)
    y = np.arange(5, dtype=np.float32)
    jt, jf = _branches(jnp)
    tt, tf = _branches(torch)
    j = jax.lax.cond(pred, jt, jf, jnp.asarray(x), jnp.asarray(y))
    with control.warmup() if warm else _null():
        t = control.cond(torch.tensor(pred), tt, tf,
                         (torch.from_numpy(x), torch.from_numpy(y)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # a carry: identity leaves the operands as they are
    ops = (torch.from_numpy(x), torch.from_numpy(y))
    out = control.cond(torch.tensor(pred), tt, control.identity, ops)
    if pred:
        assert torch.equal(out[0], ops[0] + ops[1])
    else:
        assert all(a is b for a, b in zip(out, ops))


def test_predicate_read_is_marked():
    """The helper's read is the only one `in_predicate_read` marks."""
    reads = HostReads()
    p, x = torch.tensor(True), torch.tensor(3)
    with reads:
        control.cond(p, lambda: torch.ones(2), lambda: torch.zeros(2))
    assert reads.n == 0
    with reads:
        int(x)
    assert reads.n == 1


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ---------------------------------------------------------------------------
# (b) zero host reads in the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_step_makes_no_host_read(sensor, mono, rgbd):
    slam, reads, warm, seen = {"mono": mono, "rgbd": rgbd}[sensor]
    n_st = tsystem.n_stages(slam.cfg)
    # the runs covered what the step can do: insertions, every stage (the
    # RGB-D run all but the cull), reference-keyframe tracking,
    # localisation mode; the warm-up step ran every branch (the motion
    # model's failure fallback, each stage, the keyframe cull)
    assert seen["inserted"] >= 1, seen
    ran = set(range(n_st - (sensor == "rgbd")))
    assert ran <= seen["stages"], seen
    assert seen["fallback"] >= 1 and seen["loc"] == 2, seen
    assert reads.n == 0, reads.where
    assert warm.n == 0, warm.where
    assert slam.status == OK


# ---------------------------------------------------------------------------
# (c) the frame ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fb", [1, 4])
def test_relocalisation_gets_the_lost_frame(seq, mono, fb):
    """A blank frame after the map is made is LOST; its HUD entry,
    drained at flush, starts a relocalisation on that frame, taken from
    the ring the program wrote it into.  The session starts from the mono
    run's map, first made old enough not to reset (its keyframes copied
    into free slots)."""
    src = mono[0]
    slam = tsystem.SLAM(small_cfg(frame_batch=fb), device="cpu")
    slam.state, slam.ts = src.state, src.ts
    slam.status, slam.frame_count = OK, src.frame_count
    n_fed = slam.frame_count + fb
    _feed(slam, seq, range(slam.frame_count, n_fed))
    slam.flush()
    st = slam.state
    n = int(st.next_kf)
    assert slam.status == OK and n >= 2
    dup = st._replace(**{f: torch.cat([getattr(st, f)[:n]] * 4 + [
        getattr(st, f)[4 * n:]]) for f in ("kf_valid", "kf_pose")})
    slam.state = dup._replace(next_kf=torch.tensor(4 * n, dtype=torch.int32))
    got = []
    run_reloc = slam._run_reloc
    slam._run_reloc = lambda frame: (got.append(frame.frame_id.clone()),
                                     run_reloc(frame))[1]
    lost = slam.frame_count
    blank = np.zeros_like(seq.images[0])
    slam.track_mono(blank, seq.timestamps[n_fed] + 0.01)
    # later frames, written into other slots of the ring
    _feed(slam, seq, range(n_fed + 1, n_fed + 2 + fb))
    slam.flush()
    assert got and int(got[0]) == lost


# ---------------------------------------------------------------------------
# (d) fixed buffers
# ---------------------------------------------------------------------------

def _ptrs(slam):
    return [t.data_ptr() for t in slam.state + slam.ts]


def test_host_reactions_keep_the_buffers(mono, tmp_path):
    slam = mono[0]
    before = _ptrs(slam)
    path = str(tmp_path / "map.npz")
    slam.save_map(path)
    n_kf = int(slam.state.n_kf)
    # a loop correction (its verification stubbed to accept the pair of
    # the newest keyframe and keyframe 0) and the global BA it starts
    k = int(slam.state.next_kf) - 1
    verify = tloop.verify
    N = slam.cfg.orb.max_keypoints
    try:
        tloop.verify = lambda st, kf, cand, u, cfg: (
            torch.tensor(True), torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 1.0]),
            torch.full((N,), -1, dtype=torch.int32), None)
        slam._consistency.update = lambda ids, groups: [0]
        slam._verify_loop(k, np.array([0]), np.array([[True]]))
    finally:
        tloop.verify = verify
    assert slam.last_loop_kf == k and slam._gba.active
    slam._gba.iters_left = slam._gba.iters_per_chunk     # one chunk
    slam._step_gba(to_completion=True)
    assert not slam._gba.active
    assert _ptrs(slam) == before
    # a relocalisation's result written into the track state
    frame = slam._ring_frame(0)
    T = slam.ts.T.clone()
    slam._reloc_pending = (0, (torch.tensor(True), T, slam.ts.last_pids,
                               torch.tensor(1)), frame)
    slam.status = LOST
    slam._check_reloc(force=True)
    assert slam.status == OK and int(slam.ts.ref_kf) == 1
    assert _ptrs(slam) == before
    slam.reset()
    assert int(slam.state.next_kf) == 0 and _ptrs(slam) == before
    slam.load_map(path)
    assert int(slam.state.n_kf) == n_kf and slam.status == LOST
    assert _ptrs(slam) == before
