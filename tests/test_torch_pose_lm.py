"""The motion-only pose LM of the port against the TPU kernel it replaces
and against the JAX package, on the CPU.

`scripts/study_pallas_pose.py` holds the Pallas TPU kernel (the whole 4x10
LM in one program); here it runs in interpret mode, loaded by path.  On the
same numpy-seeded problems (256 points, 20 of them outliers, mono and a
third stereo) the port's `pose_optimize_plain` — the plain version the CUDA
kernel is held against on the card — must give:

* the pose within 1e-5 (both are float32 LMs that converge to the same
  minimum; only the order of the sums differs);
* the same inlier mask on every point whose chi^2 is not within 0.1% of
  its threshold (a point at the threshold may flip under another order).

On the CPU `pose_optimize` is the plain version and launches nothing; the
kernel's wrapper refuses CPU tensors.  The kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import BAConfig as JBA
from orb_slam2_tpu.solvers import pose_opt as jpo
from orb_slam2_tpu_torch.config import BAConfig as TBA
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.solvers import pose_lm_cuda
from orb_slam2_tpu_torch.solvers import pose_opt as tpo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4 = (500.0, 500.0, 320.0, 240.0)
BF = 40.0
N, N_OUT = 256, 20


def _study_kernel():
    spec = importlib.util.spec_from_file_location(
        "study_pallas_pose", os.path.join(ROOT, "scripts",
                                          "study_pallas_pose.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_problem(seed: int, stereo_frac: float, n: int = N,
                 n_out: int = N_OUT):
    """(T0, pw, uv, ur, inv_sigma2, valid, is_stereo) as numpy arrays: a
    pose 0.05 rad / 0.1 off the truth, half-pixel noise, n_out outliers."""
    rng = np.random.RandomState(seed)
    pw = (rng.randn(n, 3) * [2.0, 2.0, 0.8] + [0, 0, 5.0]).astype(np.float32)
    T_true = lie.se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.03, -0.02, 0.01]))
    pc = lie.se3_apply(T_true, torch.from_numpy(pw)).numpy()
    uv = pc[:, :2] / pc[:, 2:] * K4[:2] + K4[2:]
    uv = (uv + rng.randn(n, 2) * 0.5).astype(np.float32)
    is_st = rng.rand(n) < stereo_frac
    ur = np.where(is_st, uv[:, 0] - BF / pc[:, 2] + rng.randn(n) * 0.5,
                  -1.0).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    uv[out] += (rng.randn(n_out, 2) * 30).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 4, n)).astype(np.float32)
    valid = rng.rand(n) < 0.97
    T0 = lie.se3_compose(lie.se3_exp(torch.tensor(
        [0.05, 0.05, -0.05, 0.03, 0.02, -0.02])), T_true).numpy()
    return T0, pw, uv, ur, inv_s2, valid, is_st


def _port(p):
    return tpo.pose_optimize_plain(
        *[torch.from_numpy(np.array(x)) for x in p], torch.tensor(K4), BF,
        TBA())


def _chi2_at(T, p):
    """Per-point chi^2 at pose T (numpy), as the LM classifies it."""
    _, pw, uv, ur, inv_s2, _, is_st = p
    pc = lie.se3_apply(torch.from_numpy(T), torch.from_numpy(pw)).numpy()
    z = np.maximum(pc[:, 2], 1e-6)
    u = K4[0] * pc[:, 0] / z + K4[2]
    v = K4[1] * pc[:, 1] / z + K4[3]
    er = np.where(is_st, ur - (u - BF / z), 0.0)
    return ((uv[:, 0] - u) ** 2 + (uv[:, 1] - v) ** 2 + er ** 2) * inv_s2


def _check(t, T_ref, inl_ref, p):
    np.testing.assert_allclose(t.T.numpy(), np.asarray(T_ref), rtol=0,
                               atol=1e-5)
    th = np.where(p[6], JBA().chi2_stereo, JBA().chi2_mono)
    clear = np.abs(_chi2_at(t.T.numpy(), p) - th) > 1e-3 * th
    inl_ref = np.asarray(inl_ref)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(t.inliers.numpy()[clear], inl_ref[clear])
    assert N - N_OUT - 20 <= int(t.n_inliers) <= N - N_OUT + 2


CASES = {"mono": 0.0, "mixed_stereo": 1.0 / 3.0}


@pytest.fixture(scope="module")
def study():
    return _study_kernel()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_tpu_kernel(study, case):
    p = make_problem(11, CASES[case])
    r = study.pose_optimize_pallas(*[jnp.asarray(x) for x in p], K4, BF,
                                   JBA(), interpret=True)
    _check(_port(p), r.T, r.inliers, p)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_pose_optimize(case):
    p = make_problem(12, CASES[case])
    j = jpo.pose_optimize(*[jnp.asarray(x) for x in p], jnp.asarray(K4), BF,
                          JBA())
    t = _port(p)
    _check(t, j.T, j.inliers, p)
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-4)


def test_pose_optimize_on_cpu_is_the_plain_version():
    p = [torch.from_numpy(np.array(x)) for x in make_problem(13, 0.2)]
    launches = pose_lm_cuda.device_launches()
    a = tpo.pose_optimize(*p, torch.tensor(K4), BF, TBA())
    b = tpo.pose_optimize_plain(*p, torch.tensor(K4), BF, TBA())
    assert pose_lm_cuda.device_launches() == launches
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pose_optimize_over_a_batch_on_cpu_equals_each_problem():
    """Three problems with a leading [3] axis (the dp step's sequences):
    each gets the bits it gets alone, and nothing launches."""
    probs = [[torch.from_numpy(np.array(x)) for x in make_problem(s, f)]
             for s, f in ((20, 0.0), (21, 1 / 3), (22, 1.0))]
    launches = pose_lm_cuda.device_launches()
    many = tpo.pose_optimize(*(torch.stack(x) for x in zip(*probs)),
                             torch.tensor(K4), BF, TBA())
    assert pose_lm_cuda.device_launches() == launches
    assert many.T.shape == (3, 7) and many.inliers.shape == (3, N)
    for i, p in enumerate(probs):
        one = tpo.pose_optimize(*p, torch.tensor(K4), BF, TBA())
        for f, x, y in zip(one._fields, one, many):
            assert torch.equal(x, y[i]), (i, f)


def test_kernel_wrapper_refuses_cpu_tensors():
    p = [torch.from_numpy(np.array(x))[None] for x in make_problem(14, 0.0)]
    with pytest.raises(ValueError, match="pose_lm_cuda expects"):
        pose_lm_cuda.pose_lm_cuda(*p, torch.tensor(K4), BF, TBA())
