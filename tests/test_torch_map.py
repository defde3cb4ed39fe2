"""Parity of the port's map/ (state helpers and mutation primitives) with
the JAX package on the CPU.

One small map is built with the JAX ops (three keyframes, shared points,
a full observer table) and carried into the port with `convert.py`; every
op then runs on both from that same state.  Integer and boolean fields
(ids, observation tables, covisibility, counters) must be equal; float
fields (positions, normals, scale bands) agree to 1e-5, as they go through
the same few f32 products in another order.  A JAX map checkpoint loads
into the port unchanged.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.core import lie as jlie
from orb_slam2_tpu.map import checkpoint as jckpt
from orb_slam2_tpu.map import empty_map as jempty
from orb_slam2_tpu.map import ops as jops
from orb_slam2_tpu.map import state as jstate
from orb_slam2_tpu.pipeline.frame import Frame as JFrame
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.map import ops as tops
from orb_slam2_tpu_torch.map import state as tstate
from orb_slam2_tpu_torch.pipeline.frame import Frame as TFrame

N, M, K, D = 16, 64, 8, 4


def _cfgs():
    kw = lambda m: dict(
        cap=m.Capacity(max_keyframes=K, max_points=M, max_obs_per_kf=N,
                       max_obs_per_point=D),
        orb=m.ORBConfig(n_features=N, max_keypoints=N, n_levels=2))
    return (jconfig.SLAMConfig(**kw(jconfig)),
            tconfig.SLAMConfig(**kw(tconfig)))


def _frame_np(seed, fid):
    rng = np.random.RandomState(seed)
    return dict(uv=(rng.rand(N, 2) * 100).astype(np.float32),
                uv_raw=(rng.rand(N, 2) * 100).astype(np.float32),
                ur=np.full(N, -1.0, np.float32),
                depth=np.full(N, -1.0, np.float32),
                octave=rng.randint(0, 2, N).astype(np.int32),
                angle=rng.rand(N).astype(np.float32),
                desc=rng.randint(0, 256, (N, 32)).astype(np.uint8),
                valid=rng.rand(N) < 0.9,
                frame_id=np.int32(fid), timestamp=np.float32(0.1 * fid))


def _jframe(f):
    return JFrame(**{k: jnp.asarray(v) for k, v in f.items()})


def _tframe(f):
    return TFrame(**{k: torch.as_tensor(np.array(v)) for k, v in f.items()})


def _pose(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(4) * 0.05 + [1, 0, 0, 0]
    return np.concatenate([q / np.linalg.norm(q), rng.randn(3) * 0.3]
                          ).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    """A JAX map: KF0 with 10 new points, KF1/KF2 re-observing some of
    them; returned as numpy fields."""
    jcfg, _ = _cfgs()
    st = jempty(jcfg)
    none = jnp.full((N,), -1, jnp.int32)
    f0 = _jframe(_frame_np(0, 0))
    st, k0 = jops.insert_keyframe(st, f0, jnp.asarray(_pose(0)), none)
    pos = np.random.RandomState(9).randn(N, 3).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2]) + 2.0
    st, pids = jops.alloc_points(st, jnp.arange(N) < 10, jnp.asarray(pos),
                                 f0.desc, k0)
    st = jops.add_obs(st, k0, jnp.arange(N), pids)
    for k, seed in ((1, 1), (2, 2)):
        obs = np.full(N, -1, np.int32)
        obs[np.random.RandomState(seed).choice(N, 7, replace=False)] = \
            np.random.RandomState(seed + 10).choice(10, 7, replace=False)
        st, _ = jops.insert_keyframe(st, _jframe(_frame_np(seed, k)),
                                     jnp.asarray(_pose(seed)),
                                     jnp.asarray(obs))
    return {f: np.asarray(v) for f, v in zip(st._fields, st)}


def _pair(fields):
    jst = jstate.MapState(*[jnp.asarray(fields[f])
                            for f in jstate.MapState._fields])
    return jst, convert.map_state_from_numpy(fields, device="cpu")


def assert_states_equal(tst, jst, atol=1e-5):
    for f, t, j in zip(jst._fields, tst, jst):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, f
        if t.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


def test_convert_roundtrip_and_empty_map(base):
    jcfg, tcfg = _cfgs()
    assert_states_equal(tstate.empty_map(tcfg, "cpu"), jempty(jcfg))
    jst, tst = _pair(base)
    assert_states_equal(tst, jst)
    back = convert.to_numpy(tst)
    for f in base:
        np.testing.assert_array_equal(back[f], base[f])


def test_jax_checkpoint_loads_into_port(base, tmp_path):
    jst, _ = _pair(base)
    path = os.path.join(tmp_path, "map.npz")
    jckpt.save_map(jst, path)
    tst = convert.map_state_from_numpy(np.load(path), device="cpu")
    assert_states_equal(tst, jst)


def test_insert_keyframe_matches_jax(base):
    jst, tst = _pair(base)
    f = _frame_np(3, 3)
    obs = np.full(N, -1, np.int32)
    obs[[1, 4, 7, 9]] = [0, 2, 5, 8]
    jst, jk = jops.insert_keyframe(jst, _jframe(f), jnp.asarray(_pose(3)),
                                   jnp.asarray(obs))
    tst, tk = tops.insert_keyframe(tst, _tframe(f), torch.from_numpy(_pose(3)),
                                   torch.from_numpy(obs))
    assert tk == int(jk) == 3
    assert_states_equal(tst, jst)


def test_alloc_points_matches_jax(base):
    jst, tst = _pair(base)
    rng = np.random.RandomState(4)
    want = rng.rand(N) < 0.6
    pos = rng.randn(N, 3).astype(np.float32)
    desc = rng.randint(0, 256, (N, 32)).astype(np.uint8)
    jst, jp = jops.alloc_points(jst, jnp.asarray(want), jnp.asarray(pos),
                                jnp.asarray(desc), 2)
    tst, tp = tops.alloc_points(tst, torch.from_numpy(want),
                                torch.from_numpy(pos), torch.from_numpy(desc),
                                2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_states_equal(tst, jst)


def test_add_obs_matches_jax(base):
    jst, tst = _pair(base)
    pids = np.full(N, -1, np.int32)
    pids[[0, 3, 5]] = [9, 8, 7]
    kp = np.arange(N, dtype=np.int32)
    jst = jops.add_obs(jst, 2, jnp.asarray(kp), jnp.asarray(pids))
    tst = tops.add_obs(tst, 2, torch.from_numpy(kp), torch.from_numpy(pids))
    assert_states_equal(tst, jst)


def test_add_obs_multi_matches_jax(base):
    jst, tst = _pair(base)
    kf = np.asarray([0, 1, 2, 1, -1, 2], np.int32)
    kp = np.asarray([11, 12, 13, 14, 15, 15], np.int32)
    pids = np.asarray([3, 4, 5, 6, 7, -1], np.int32)
    jst = jops.add_obs_multi(jst, *map(jnp.asarray, (kf, kp, pids)))
    tst = tops.add_obs_multi(tst, *map(torch.from_numpy, (kf, kp, pids)))
    assert_states_equal(tst, jst)


def test_remove_obs_matches_jax(base):
    jst, tst = _pair(base)
    removal = np.random.RandomState(5).rand(K, N) < 0.3
    assert_states_equal(tops.remove_obs_global(tst, torch.from_numpy(removal)),
                        jops.remove_obs_global(jst, jnp.asarray(removal)))
    mask = removal[1]
    assert_states_equal(tops.remove_obs(tst, 1, torch.from_numpy(mask)),
                        jops.remove_obs(jst, 1, jnp.asarray(mask)))


def test_cull_and_replace_points_match_jax(base):
    jst, tst = _pair(base)
    bad = np.zeros(M, bool)
    bad[[1, 6]] = True
    assert_states_equal(tops.cull_points(tst, torch.from_numpy(bad)),
                        jops.cull_points(jst, jnp.asarray(bad)))
    src = np.full(M, -1, np.int32)
    dst = np.full(M, -1, np.int32)
    src[[0, 4]], dst[[0, 4]] = [0, 4], [2, 3]
    jr = jops.replace_points(jst, jnp.asarray(src), jnp.asarray(dst))
    tr = tops.replace_points(tst, torch.from_numpy(src), torch.from_numpy(dst))
    assert_states_equal(tr, jr)
    pid = np.asarray([0, 1, 4, -1, 3], np.int32)
    np.testing.assert_array_equal(
        tstate.resolve_replaced(tr, torch.from_numpy(pid)).numpy(),
        np.asarray(jstate.resolve_replaced(jr, jnp.asarray(pid))))


def test_update_point_attributes_matches_jax(base):
    jst, tst = _pair(base)
    pmask = np.arange(M) < 12
    jst = jops.update_point_attributes(jst, jnp.asarray(pmask), 1.2, 8)
    tst = tops.update_point_attributes(tst, torch.from_numpy(pmask), 1.2, 8)
    assert_states_equal(tst, jst)


def test_state_helpers_match_jax(base):
    jst, tst = _pair(base)
    for name in ("point_obs_count", "weighted_obs_count"):
        np.testing.assert_array_equal(getattr(tstate, name)(tst).numpy(),
                                      np.asarray(getattr(jstate, name)(jst)))
    for k in range(3):
        assert_states_equal(tstate.update_covisibility_for_kf(tst, k),
                            jstate.update_covisibility_for_kf(jst, k))
        assert int(tstate.spanning_parent_for_kf(tst, k)) == \
            int(jstate.spanning_parent_for_kf(jst, k))
        for n in (2, 4):
            np.testing.assert_array_equal(
                tstate.covisible_neighbors(tst, k, n).numpy(),
                np.asarray(jstate.covisible_neighbors(jst, k, n)))


def test_first_flagged_is_lax_top_k_order():
    """`lax.top_k(mask.astype(int32), P)` picks the first P flagged ids in
    ascending order, then the first unflagged ones; the port's stable form
    must give the same list."""
    import jax
    rng = np.random.RandomState(6)
    for P in (5, 40, 100):
        mask = rng.rand(100) < 0.3
        j = np.asarray(jax.lax.top_k(jnp.asarray(mask.astype(np.int32)), P)[1])
        t = tstate.first_flagged(torch.from_numpy(mask), P).numpy()
        np.testing.assert_array_equal(t, j)
