"""Parity of the port's solvers/ with the JAX package on the CPU.

* pose_optimize: the same 4x10 Huber LM on the same inputs.  Each step is a
  6x6 solve of sums over ~150 points taken in another order, so the poses
  agree to 1e-4 (quaternion and translation components) and the inlier
  sets are equal.
* triangulate_dlt: the same closed forms; points of depth ~5 agree to
  1e-4 relative.
* twoview.initialize: the JAX package draws its RANSAC sets from
  `jax.random`, which torch cannot reproduce, so JAX's own `_sample_sets`
  output is fed to both.  The 8-point and DLT null vectors come out of an
  SVD with a free sign, which H, F and E carry; the scores and the
  recovered motion do not depend on it.  Decisions (ok, used_h) must be
  equal, the pose equal up to quaternion sign to 1e-3, and the
  triangulation inlier masks nearly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import BAConfig as JBA
from orb_slam2_tpu.config import InitConfig as JInit
from orb_slam2_tpu.core import camera as jcam
from orb_slam2_tpu.core import lie as jlie
from orb_slam2_tpu.solvers import pose_opt as jpo
from orb_slam2_tpu.solvers import triangulate as jtri
from orb_slam2_tpu.solvers import twoview as jtv
from orb_slam2_tpu_torch.config import BAConfig as TBA
from orb_slam2_tpu_torch.config import InitConfig as TInit
from orb_slam2_tpu_torch.solvers import pose_opt as tpo
from orb_slam2_tpu_torch.solvers import triangulate as ttri
from orb_slam2_tpu_torch.solvers import twoview as ttv

K = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)


def _scene(n, seed, depth=5.0, spread=2.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * [spread, spread, spread * 0.4]
            + [0, 0, depth]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_pose(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    q = a[:4] if np.dot(a[:4], b[:4]) >= 0 else -a[:4]
    np.testing.assert_allclose(q, b[:4], rtol=0, atol=atol)
    np.testing.assert_allclose(a[4:], b[4:], rtol=0, atol=atol)


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimize_matches_jax(stereo):
    n = 150
    pts = _scene(n, 5)
    xi = np.asarray([0.05, -0.03, 0.02, 0.02, -0.01, 0.015], np.float32)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pc = np.asarray(jlie.se3_apply(jnp.asarray(T_true), jnp.asarray(pts)))
    rng = np.random.RandomState(6)
    uv = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(pc)))
    uv = (uv + rng.randn(n, 2) * 0.5).astype(np.float32)
    out = rng.choice(n, 22, replace=False)
    uv[out] += (rng.randn(22, 2) * 40).astype(np.float32)
    bf = 40.0 if stereo else 0.0
    ur = (uv[:, 0] - bf / pc[:, 2]).astype(np.float32) if stereo \
        else np.zeros(n, np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 3, n)).astype(np.float32)
    valid = rng.rand(n) < 0.95
    is_st = np.full(n, stereo)
    T0 = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    j = jpo.pose_optimize(jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
                          jnp.asarray(ur), jnp.asarray(inv_s2),
                          jnp.asarray(valid), jnp.asarray(is_st),
                          jnp.asarray(K), bf, JBA())
    t = tpo.pose_optimize(_t(T0), _t(pts), _t(uv), _t(ur), _t(inv_s2),
                          _t(valid), _t(is_st), _t(K), bf, TBA())
    _same_pose(t.T.numpy(), j.T, 1e-4)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 100
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-3)


def test_triangulate_dlt_matches_jax():
    pts = _scene(256, 0)
    T1 = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    T2 = np.asarray(jlie.se3_exp(jnp.asarray(
        [-0.2, 0.01, 0.0, 0.0, 0.02, 0.01], np.float32)))
    rng = np.random.RandomState(1)

    def obs(T):
        p = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(pts)))
        return (p[:, :2] / p[:, 2:] + rng.randn(256, 2) * 1e-3
                ).astype(np.float32)

    xn1, xn2 = obs(T1), obs(T2)
    j = np.asarray(jtri.triangulate_dlt(jnp.asarray(T1)[None],
                                        jnp.asarray(T2)[None],
                                        jnp.asarray(xn1), jnp.asarray(xn2)))
    t = ttri.triangulate_dlt(_t(T1)[None], _t(T2)[None], _t(xn1),
                             _t(xn2)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    Kt = _t(K)
    for name in ("depth_in", "reprojection_error"):
        args_j = (jnp.asarray(T2), jnp.asarray(j)) if name == "depth_in" \
            else (jnp.asarray(T2), jnp.asarray(K), jnp.asarray(j),
                  jnp.asarray(xn2 * 500 + 300))
        args_t = (_t(T2), _t(j)) if name == "depth_in" \
            else (_t(T2), Kt, _t(j), _t(xn2 * 500 + 300))
        np.testing.assert_allclose(getattr(ttri, name)(*args_t).numpy(),
                                   np.asarray(getattr(jtri, name)(*args_j)),
                                   rtol=1e-5, atol=1e-3)


def _twoview_inputs(kind, seed):
    rng = np.random.RandomState(seed)
    n = 200
    if kind == "planar":
        xy = rng.rand(n, 2) * 4 - 2
        pts = np.concatenate([xy, np.full((n, 1), 4.0)], -1)
        tilt = np.asarray(jlie.so3_exp(jnp.asarray([0.4, 0.2, 0.0])))
        pts = np.asarray(jlie.quat_rotate(jnp.asarray(tilt)[None],
                                          jnp.asarray(pts - [0, 0, 4.0],
                                                      np.float32))) + \
            [0, 0, 4.0]
        xi = [-0.25, 0.0, 0.05, 0.0, 0.04, 0.0]
    else:
        pts = _scene(n, seed)
        xi = [-0.3, 0.02, 0.0, 0.0, 0.03, 0.01]
    pts = np.asarray(pts, np.float32)
    T2 = jlie.se3_exp(jnp.asarray(xi, np.float32))
    uv1 = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(pts)))
    uv2 = np.asarray(jcam.project(jnp.asarray(K),
                                  jlie.se3_apply(T2, jnp.asarray(pts))))
    uv1 = (uv1 + rng.randn(n, 2) * 0.3).astype(np.float32)
    uv2 = (uv2 + rng.randn(n, 2) * 0.3).astype(np.float32)
    valid = rng.rand(n) < 0.97
    return uv1, uv2, valid


@pytest.mark.parametrize("kind,seed", [("general", 1), ("general", 11),
                                       ("planar", 3)])
def test_twoview_initialize_matches_jax_on_same_sets(kind, seed):
    uv1, uv2, valid = _twoview_inputs(kind, seed)
    jcfg, tcfg = JInit(ransac_iters=64), TInit(ransac_iters=64)
    key = jax.random.PRNGKey(seed)
    sets = np.asarray(jtv._sample_sets(jax.random.split(key)[0],
                                       jnp.asarray(valid), 64, 8))
    j = jtv.initialize(key, jnp.asarray(K), jnp.asarray(uv1),
                       jnp.asarray(uv2), jnp.asarray(valid), jcfg)
    t = ttv.initialize(_t(K), _t(uv1), _t(uv2), _t(valid), _t(sets).long(),
                       tcfg)
    assert bool(j.ok) and bool(t.ok)
    assert bool(t.used_h) == bool(j.used_h) == (kind == "planar")
    _same_pose(t.T21.numpy(), j.T21, 1e-3)
    agree = t.good.numpy() == np.asarray(j.good)
    assert agree.mean() >= 0.98, agree.mean()
    both = t.good.numpy() & np.asarray(j.good)
    np.testing.assert_allclose(t.points.numpy()[both],
                               np.asarray(j.points)[both], rtol=1e-2,
                               atol=1e-2)


def test_sample_sets_draw_among_valid_in_strata():
    """The port's own sampler: each of the 8 slots draws from its stratum
    of the valid entries (the JAX sampler's rule), reproducibly per seed."""
    valid = torch.from_numpy(np.random.RandomState(0).rand(300) < 0.7)
    gen = torch.Generator().manual_seed(3)
    a = ttv.sample_sets(gen, valid, 64)
    b = ttv.sample_sets(torch.Generator().manual_seed(3), valid, 64)
    assert torch.equal(a, b) and a.shape == (64, 8)
    assert bool(valid[a].all())
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    nv = int(valid.sum())
    j = torch.arange(8)
    assert bool((rank[a] >= (j * nv) // 8).all())
    assert bool((rank[a] < -(-(j + 1) * nv // 8)).all())
