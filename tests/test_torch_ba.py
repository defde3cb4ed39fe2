"""Parity of the port's ba/ (Schur-complement LM, local and global BA) with
the JAX package on the CPU.

The map comes from a JAX monocular run of 15 frames on the small
configuration (the vocabulary off), carried into the port with
`convert.py`; its poses and points are then perturbed from a numpy seed so
that every solve has real work to do.  Both frameworks solve from that same
state.  Each LM step is a Cholesky/CG solve over sums taken in another
order, so poses agree to 1e-4 and points (depths of 2-8 m) to 1e-3; the
observation tables after outlier removal must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.ba import local as jlocal
from orb_slam2_tpu.ba import schur as jschur
from orb_slam2_tpu.io import synthetic as jsyn
from orb_slam2_tpu.map.state import MapState as JMap
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ba import local as tlocal
from orb_slam2_tpu_torch.ba import schur as tschur

POSE_TOL, POINT_TOL = 1e-4, 1e-3


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


@pytest.fixture(scope="module")
def perturbed_map(tmp_path_factory):
    cfg = small_cfg(jconfig)
    seq = jsyn.generate(cfg.camera, n_frames=15, n_points=300,
                        trajectory="xyz", seed=0)
    no_vocab = tmp_path_factory.mktemp("vocab") / "absent.npz"
    slam = JSLAM(cfg, vocab_path=str(no_vocab))
    for f in range(15):
        slam.track_mono(seq.images[f], seq.timestamps[f])
    slam.flush()
    fields = {f: np.array(v) for f, v in zip(slam.state._fields, slam.state)}
    assert int(fields["kf_valid"].sum()) >= 3
    rng = np.random.RandomState(0)
    var = fields["kf_valid"] & (np.arange(len(fields["kf_valid"])) > 0)
    fields["kf_pose"][var, 4:] += rng.randn(var.sum(), 3).astype(
        np.float32) * 0.01
    mv = fields["mp_valid"]
    fields["mp_pos"][mv] += rng.randn(mv.sum(), 3).astype(np.float32) * 0.02
    return fields


def _pair(fields):
    return (JMap(*[jnp.asarray(fields[f]) for f in JMap._fields]),
            convert.map_state_from_numpy(fields, device="cpu"))


def _assert_close(tst, jst, before):
    t = convert.to_numpy(tst)
    for f, tol in (("kf_pose", POSE_TOL), ("mp_pos", POINT_TOL)):
        j = np.asarray(getattr(jst, f))
        assert np.abs(j - before[f]).max() > 10 * tol, f"{f} did not move"
        np.testing.assert_allclose(t[f], j, rtol=0, atol=tol, err_msg=f)
    for f in ("kf_obs", "mp_obs_kf", "mp_obs_kp"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(jst, f)),
                                      err_msg=f)


def test_local_ba_matches_jax(perturbed_map):
    jst, tst = _pair(perturbed_map)
    k = int(perturbed_map["next_kf"]) - 1
    jout, jlam = jlocal.local_ba(jst, k, small_cfg(jconfig), n_outer=5,
                                 lam0=1e-4, return_lam=True)
    tout, tlam = tlocal.local_ba(tst, k, small_cfg(tconfig), n_outer=5,
                                 lam0=torch.tensor(1e-4), return_lam=True)
    _assert_close(tout, jout, perturbed_map)
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=1e-6)


def test_local_ba_over_sequences_equals_each_alone(perturbed_map):
    """Two local BAs solved together (the map twice, around its newest
    keyframe and the one before, each with its own damping) give each
    sequence the bits of its own S = 1 solve: every product, solve and
    cost sum of the batched LM runs once a problem (`core/seqwise.py`)."""
    _, tst = _pair(perturbed_map)
    cfg = small_cfg(tconfig)
    k = int(perturbed_map["next_kf"]) - 1
    ks, lams = torch.tensor([k, k - 1]), torch.tensor([1e-4, 1e-2])
    stacked = type(tst)(*(torch.stack([x, x]) for x in tst))
    many, mlam = tlocal.local_ba(stacked, ks, cfg, n_outer=5, lam0=lams,
                                 return_lam=True)
    for s in range(2):
        one, lam = tlocal.local_ba(tst, int(ks[s]), cfg, n_outer=5,
                                   lam0=lams[s], return_lam=True)
        assert torch.equal(mlam[s], lam), s
        for f, x, y in zip(tst._fields, many, one):
            assert torch.equal(x[s], y), (s, f)
    assert not torch.equal(many.kf_pose[0], many.kf_pose[1])


def test_global_ba_dense_matches_jax(perturbed_map):
    """96 keyframes <= 256: both take the dense Schur path."""
    jst, tst = _pair(perturbed_map)
    jout = jlocal.global_ba(jst, small_cfg(jconfig), n_outer=10, n_cg=40)
    tout = tlocal.global_ba(tst, small_cfg(tconfig), n_outer=10, n_cg=40)
    _assert_close(tout, jout, perturbed_map)


def test_global_ba_cg_matches_jax(perturbed_map):
    """The matrix-free PCG path that the default 512-keyframe map takes.

    With keyframe 0 alone held, a monocular map keeps its scale free: the
    reduced camera system is near-singular along it, and 40 CG iterations
    stop at points that rounding moves apart along that direction (by up
    to 0.1 in a pose on this map) at the same cost.  So the entry point is
    held to the JAX cost (0.5%), and the solver itself to the poses and
    points, on the same problem with keyframe 1 held as well."""
    jst, tst = _pair(perturbed_map)
    jcfg, tcfg = small_cfg(jconfig), small_cfg(tconfig)
    jp = jlocal.build_global_problem_point_major(jst, jcfg)
    tp = tlocal.build_global_problem_point_major(tst, tcfg)
    for f in ("cam_var", "pt_var", "obs_cam", "obs_pid", "obs_w", "obs_uv"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    jr = jschur.ba_solve(jp, n_outer=10, n_cg=40)
    tout = tlocal.global_ba_cg(tst, tcfg, n_outer=10, n_cg=40)
    e, _, _ = tschur._residuals(tp, tout.kf_pose, tout.mp_pos)
    t_cost = float((torch.sum(e * e, -1) * tp.obs_w).sum())
    np.testing.assert_allclose(t_cost, float(jr.chi2.sum()), rtol=5e-3)
    np.testing.assert_array_equal(tout.kf_obs.numpy(), perturbed_map["kf_obs"])

    held = np.arange(len(perturbed_map["kf_valid"])) >= 2
    jr = jschur.ba_solve(jp._replace(cam_var=jp.cam_var & held), n_outer=10,
                         n_cg=40)
    tr = tschur.ba_solve(tp._replace(cam_var=tp.cam_var &
                                     torch.from_numpy(held)),
                         n_outer=10, n_cg=40)
    assert np.abs(np.asarray(jr.cam_pose) - perturbed_map["kf_pose"]).max() \
        > 10 * POSE_TOL
    np.testing.assert_allclose(tr.cam_pose.numpy(), np.asarray(jr.cam_pose),
                               rtol=0, atol=POSE_TOL)
    # weakly observed points drift ~1e-3 relative between 40-step CG runs
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                               rtol=POINT_TOL, atol=POINT_TOL)
    np.testing.assert_array_equal(tr.inlier.numpy(), np.asarray(jr.inlier))


def test_local_problem_matches_jax(perturbed_map):
    jst, tst = _pair(perturbed_map)
    k = int(perturbed_map["next_kf"]) - 1
    jp, jr, jc, _, _ = jlocal.build_local_problem(jst, k, small_cfg(jconfig))
    tp, tr, tc, _, _ = tlocal.build_local_problem(tst, k, small_cfg(tconfig))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    for f in ("cam_var", "pt_var", "obs_cam", "obs_pid"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in ("cam_pose", "points", "obs_uv", "obs_w"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["_inv3x3", "_chol3x3"])
def test_schur_block_helpers_match_jax(name):
    """Closed-form 3x3 blocks: the same expressions, 1e-5 relative."""
    rng = np.random.RandomState(1)
    A = rng.randn(64, 3, 3).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32) * 0.5
    A[0] = 0.0                            # zero block (a point with no obs)
    j = np.asarray(getattr(jschur, name)(jnp.asarray(A)))
    t = getattr(tschur, name)(torch.from_numpy(A)).numpy()
    scale = np.abs(j).max(axis=(1, 2), keepdims=True) + 1e-6
    np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=1e-5)


def test_huber_weight_matches_jax():
    chi2 = np.abs(np.random.RandomState(2).randn(256) * 10).astype(np.float32)
    np.testing.assert_allclose(
        tschur._huber_w(torch.from_numpy(chi2), 5.991).numpy(),
        np.asarray(jschur._huber_w(jnp.asarray(chi2), 5.991)), rtol=1e-6)

