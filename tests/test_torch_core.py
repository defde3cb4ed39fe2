"""Parity of the port's core/ (SE3 quaternion ops, pinhole camera) with the
JAX package, on the CPU, from numpy-seeded inputs.

Tolerance 1e-5 absolute in float32: both sides evaluate the same closed
forms, but XLA and PyTorch may fuse and order the few products differently
(one or two ulps on values of order 1).  se3_log goes through a 3x3 solve
on each side (jnp.linalg.solve vs torch.linalg.solve_ex), so its bound is
1e-4.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.core import camera as jcam
from orb_slam2_tpu.core import lie as jlie
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch.core import camera as tcam
from orb_slam2_tpu_torch.core import lie as tlie

ATOL = 1e-5


def _quat(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pose(rng, n):
    return np.concatenate([_quat(rng, n), rng.randn(n, 3).astype(np.float32)],
                          -1).astype(np.float32)


def _both(name, *args):
    j = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    t = getattr(tlie, name)(*[torch.from_numpy(a) for a in args])
    return np.asarray(j), t.numpy()


def _inputs(name, rng):
    n = 64
    if name in ("quat_normalize", "quat_conj", "quat_to_matrix", "so3_log"):
        return (rng.randn(n, 4).astype(np.float32),)
    if name == "quat_mul":
        return _quat(rng, n), _quat(rng, n)
    if name == "quat_rotate":
        return _quat(rng, n), rng.randn(n, 3).astype(np.float32)
    if name in ("so3_exp", "hat"):
        return (rng.randn(n, 3).astype(np.float32),)
    if name in ("se3_inverse", "se3_matrix", "se3_log"):
        return (_pose(rng, n),)
    if name == "se3_compose":
        return _pose(rng, n), _pose(rng, n)
    if name == "se3_apply":
        return _pose(rng, n), rng.randn(n, 3).astype(np.float32)
    if name == "se3_exp":
        return ((rng.randn(n, 6) * 0.8).astype(np.float32),)
    if name == "se3_retract":
        return _pose(rng, n), (rng.randn(n, 6) * 0.3).astype(np.float32)
    if name == "matrix_to_quat":
        return (np.array(jlie.quat_to_matrix(jnp.asarray(_quat(rng, n)))),)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_mul", "quat_conj", "quat_rotate",
    "quat_to_matrix", "matrix_to_quat", "so3_exp", "so3_log", "hat",
    "se3_compose", "se3_inverse", "se3_apply", "se3_matrix", "se3_exp",
    "se3_retract", "se3_log"])
def test_lie_matches_jax(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    j, t = _both(name, *_inputs(name, rng))
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=1e-4 if name == "se3_log" else ATOL)


def test_so3_small_angle_matches_jax():
    phi = np.asarray([[1e-10, 0, 0], [0, 0, 0], [1e-6, -2e-6, 0]], np.float32)
    j, t = _both("so3_exp", phi)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    j, t = _both("se3_exp", np.concatenate([phi, phi], -1))
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def _cams():
    kw = dict(fx=200.0, fy=210.0, cx=160.0, cy=120.0, width=320, height=240,
              k1=0.05, k2=-0.01, p1=0.001, p2=-0.002, k3=0.003)
    return jconfig.CameraConfig(**kw), tconfig.CameraConfig(**kw)


def test_camera_project_matches_jax():
    jc, tc = _cams()
    rng = np.random.RandomState(1)
    p = rng.randn(256, 3).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    j = jcam.project(jcam.intrinsics(jc), jnp.asarray(p))
    t = tcam.project(tcam.intrinsics(tc), torch.from_numpy(p))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-4)


def test_camera_undistort_matches_jax():
    """Eight fixed-point iterations on both sides; pixel values of order
    100, so 1e-4 px is a few ulps."""
    jc, tc = _cams()
    rng = np.random.RandomState(2)
    uv = (rng.rand(256, 2) * [320, 240]).astype(np.float32)
    j = jcam.undistort_points(jcam.intrinsics(jc), jcam.distortion(jc),
                              jnp.asarray(uv))
    t = tcam.undistort_points(tcam.intrinsics(tc), tcam.distortion(tc),
                              torch.from_numpy(uv))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)


def test_camera_in_image_matches_jax():
    rng = np.random.RandomState(3)
    uv = (rng.rand(512, 2) * 400 - 40).astype(np.float32)
    bounds = np.asarray([0.0, 320.0, 0.0, 240.0], np.float32)
    j = jcam.in_image(jnp.asarray(uv), jnp.asarray(bounds))
    t = tcam.in_image(torch.from_numpy(uv), torch.from_numpy(bounds))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
