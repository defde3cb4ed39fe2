"""The port's sharded solvers (`orb_slam2_tpu_torch/distributed/`) against
the JAX package's, on the CPU.

One module-scoped spawn of 2 gloo ranks (`distributed/launch.py`), joined
by `init_multihost` from the SLAM_* env vars, runs the three sharded
solvers twice each on small problems (in a background thread of this
process, beside the tests that need no rank) and writes every rank's
results: observation-sharded BA on 16 cameras x 512 stereo points,
landmark-sharded BA on 8 cameras x 512 stereo points (point-major), and
the pose graph of a 24-node ring.  The problems are tests/test_ba.py's and
tests/test_posegraph.py's recipes, rebuilt from the same numpy seeds on
the port's `core/lie.py`; both packages get the same numpy fields.

Each result is held against the JAX function it ports on a 2-device mesh
of the conftest's CPU devices, so that both shard the same rows, and
against the port's single-rank solver, at tests/test_distributed.py's
tolerances: the sums run in another order, so observation-sharded poses
agree to 1e-4 and points to 1e-3; landmark-sharded (a bigger problem per
shard, with the gauge pinned by stereo rows) to 1e-3 and 1e-2; pose-graph
nodes to 1e-3.  The ranks must agree bit for bit, and so must the two
runs of each solve.
"""

import datetime
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam2_tpu.ba import posegraph as jposegraph
from orb_slam2_tpu.ba import schur as jschur
from orb_slam2_tpu.distributed import ba as jdba
from orb_slam2_tpu.distributed import posegraph as jdpg
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ba import posegraph as tposegraph
from orb_slam2_tpu_torch.ba import schur as tschur
from orb_slam2_tpu_torch.distributed import ba as tdba
from orb_slam2_tpu_torch.distributed import launch
from orb_slam2_tpu_torch.distributed import posegraph as tdpg
from tests.test_ba import _make_problem, _pose_err
from tests.test_posegraph import _ring_problem

POSE_TOL, POINT_TOL = 1e-4, 1e-3           # test_torch_ba.py
PM_POSE_TOL, PM_POINT_TOL = 1e-3, 1e-2     # test_distributed.py, v2
PG_TOL = 1e-3
BA_ITERS = dict(n_outer=8, n_cg=25)
PG_ITERS = dict(n_outer=10, n_cg=20)
C_PM, P_PM = 8, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; the port's
    small tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    # stereo rows pin the scale gauge: at this size a mono problem's free
    # gauge wanders by 0.15 m between any two summation orders, even
    # unsharded, which is not the equivalence under test
    obs, _, _ = launch.make_ba_problem(n_cams=16, n_pts=512, noise_px=0.4,
                                       pose_noise=0.02, pt_noise=0.02,
                                       stereo=True, seed=11)
    pm, _, _ = launch.make_ba_problem(n_cams=C_PM, n_pts=P_PM, noise_px=0.4,
                                      pose_noise=0.02, pt_noise=0.02,
                                      stereo=True, seed=7)
    pg, _ = launch.make_ring_problem(n=24, drift=0.015, seed=2)
    return {"obs": obs, "pt": launch.to_point_major(pm, C_PM, P_PM),
            "pg": pg}


def _run_ranks(problems, out):
    jobs = [dict(name="obs", kind="obs", problem=problems["obs"],
                 **BA_ITERS),
            dict(name="pt", kind="pt", problem=problems["pt"], D=C_PM,
                 **BA_ITERS),
            dict(name="pg", kind="pg", problem=problems["pg"], **PG_ITERS)]
    launch.spawn(launch.solve_worker, 2, (jobs, str(out), "cpu", "gloo", 2),
                 timeout=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _run_jax(problems):
    """The JAX functions on a 2-device mesh: {job: numpy outputs}."""
    obs = jdba.distributed_ba_solve(_jprob(problems["obs"]),
                                    jdba.make_obs_mesh(2), **BA_ITERS)
    pt = jdba.distributed_ba_solve_sharded(
        _jprob(problems["pt"]), jdba.make_pt_mesh(2), D=C_PM, **BA_ITERS)
    nodes, _ = jdpg.distributed_pose_graph(
        _jgraph(problems["pg"]), jdpg.make_edge_mesh(2), **PG_ITERS)
    res = {k: {f: np.asarray(v) for f, v in r._asdict().items()}
           for k, r in (("obs", obs), ("pt", pt))}
    res["pg"] = {"nodes": np.asarray(nodes)}
    return res


@pytest.fixture(autouse=True, scope="module")
def futures(problems, tmp_path_factory):
    """The ranks, and JAX's compiles and solves (XLA's compiler releases
    the GIL), run from the module's first test on, beside the tests that
    need neither."""
    with ThreadPoolExecutor(2) as ex:
        yield {"ranks": ex.submit(_run_ranks, problems,
                                  tmp_path_factory.mktemp("ranks")),
               "jax": ex.submit(_run_jax, problems)}


@pytest.fixture(scope="module")
def ranks(futures):
    """Both ranks' results, {output: array} per rank."""
    return futures["ranks"].result()


@pytest.fixture(scope="module")
def jax_out(futures):
    return futures["jax"].result()


@pytest.fixture(scope="module")
def one_rank_group():
    """This process as a 1-rank gloo group."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    yield dist.group.WORLD
    dist.destroy_process_group()


def _jprob(fields):
    return jschur.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})


def _jgraph(fields):
    return jposegraph.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in fields.items()})


def _tprob(fields):
    return convert.ba_problem_from_numpy(fields, device="cpu")


def _tgraph(fields):
    return convert.pose_graph_problem_from_numpy(fields, device="cpu")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stereo", [False, True])
def test_ba_problem_recipe_matches_test_ba(stereo):
    """`launch.make_ba_problem` rebuilds tests/test_ba.py's `_make_problem`
    on the port's lie group: the same rows, values within f32 round-off
    of the two packages' exp maps and projections."""
    t, t_gt, _ = launch.make_ba_problem(n_cams=6, n_pts=120, stereo=stereo,
                                        seed=3)
    j, j_gt, _ = _make_problem(n_cams=6, n_pts=120, stereo=stereo, seed=3)
    for f in ("cam_var", "pt_var", "obs_cam", "obs_pid", "obs_w"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(j, f)))
    for f, tol in (("cam_pose", 1e-6), ("points", 1e-6), ("obs_uv", 1e-3),
                   ("obs_ur", 1e-3), ("K", 0), ("bf", 0)):
        np.testing.assert_allclose(t[f], np.asarray(getattr(j, f)), rtol=0,
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(t_gt, np.asarray(j_gt), rtol=0, atol=1e-6)


def test_ring_recipe_matches_test_posegraph():
    t, t_gt = launch.make_ring_problem(n=24, drift=0.015, seed=2)
    j, j_gt = _ring_problem(n=24, drift=0.015, seed=2)
    for f in ("node_valid", "node_fixed", "edge_i", "edge_j", "edge_w",
              "fix_scale"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(j, f)))
    for f in ("nodes", "edge_meas"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(t_gt, np.asarray(j_gt), rtol=0, atol=1e-6)


def _same_arrays(t, j):
    for f, a in zip(t._fields, t):
        b = getattr(j, f)
        if torch.is_tensor(a):
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("shards", [3, 5])
def test_padding_matches_jax(problems, shards):
    """pad_problem, pad_point_major and pad_edges give exactly JAX's
    arrays (rows, fill values, dtypes), for shard counts that pad."""
    obs = {k: v[:-7] for k, v in problems["obs"].items()
           if k.startswith("obs_")}
    obs = dict(problems["obs"], **obs)
    _same_arrays(tdba.pad_problem(_tprob(obs), shards),
                 jdba.pad_problem(_jprob(obs), shards))
    pm = dict(problems["pt"])
    pm = dict(pm, points=pm["points"][:-1], pt_var=pm["pt_var"][:-1],
              **{k: pm[k][:-C_PM] for k in pm if k.startswith("obs_")})
    _same_arrays(tdba.pad_point_major(_tprob(pm), C_PM, shards),
                 jdba.pad_point_major(_jprob(pm), C_PM, shards))
    pg = problems["pg"]
    _same_arrays(tdpg.pad_edges(_tgraph(pg), shards),
                 jdpg.pad_edges(_jgraph(pg), shards))


def test_no_group_is_bit_identical_to_a_one_rank_group(problems,
                                                       one_rank_group):
    """The reduction hook changes no arithmetic: each solver with
    `group=None` (no collective at all) and on a 1-rank group (every sum
    all-reduced, the identity) gives the same bits."""
    g = one_rank_group
    obs = _tprob(problems["obs"])
    for kw in ({}, {"pt_owner_complete": True}):
        a = tschur.ba_solve(obs, n_outer=3, n_cg=10, **kw)
        b = tschur.ba_solve(obs, n_outer=3, n_cg=10, group=g, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # the dense solver on the camera-major grid: every point seen once by
    # every camera
    C, P = 16, 512
    pt_obs_r = torch.arange(C, dtype=torch.int32)[None, :] * P + \
        torch.arange(P, dtype=torch.int32)[:, None]
    a = tschur.ba_solve_dense(obs, pt_obs_r, P, n_outer=3)
    b = tschur.ba_solve_dense(obs, pt_obs_r, P, n_outer=3, group=g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pg = _tgraph(problems["pg"])
    a = tposegraph.optimize_pose_graph(pg, n_outer=3, n_cg=5)
    b = tposegraph.optimize_pose_graph(pg, n_outer=3, n_cg=5, group=g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job", ["obs", "pt", "pg"])
def test_ranks_agree_and_repeat_bit_for_bit(ranks, job):
    """Replicated outputs (cameras, nodes) and the assembled sharded ones
    are the same bits on both ranks and in both runs."""
    keys = [k for k in ranks[0] if k.startswith(job + ".") and
            k.endswith(".0")]
    assert keys
    for k in keys:
        again = k[:-1] + "1"
        for r in range(2):
            np.testing.assert_array_equal(ranks[r][k], ranks[r][again],
                                          err_msg=k)
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _ba_close(pose, points, inlier, ref_pose, ref_points, ref_inlier,
              pose_tol, point_tol):
    assert _pose_err(jnp.asarray(pose), jnp.asarray(ref_pose),
                     align_scale=False) < pose_tol
    np.testing.assert_allclose(points, ref_points, rtol=0, atol=point_tol)
    np.testing.assert_array_equal(inlier, ref_inlier)


@pytest.mark.parametrize("job", ["obs", "pt"])
def test_sharded_ba_matches_jax_and_one_rank(problems, ranks, jax_out, job):
    """Observation-sharded ("obs") and landmark-sharded ("pt") BA."""
    pose_tol, point_tol = {"obs": (POSE_TOL, POINT_TOL),
                           "pt": (PM_POSE_TOL, PM_POINT_TOL)}[job]
    one = tschur.ba_solve(_tprob(problems[job]), **BA_ITERS)
    j = jax_out[job]
    assert float(np.abs(j["cam_pose"] - problems[job]["cam_pose"]).max()) \
        > 10 * pose_tol
    r = ranks[0]
    got = (r[f"{job}.cam_pose.0"], r[f"{job}.points.0"],
           r[f"{job}.inlier.0"])
    _ba_close(*got, j["cam_pose"], j["points"], j["inlier"], pose_tol,
              point_tol)
    _ba_close(*got, one.cam_pose.numpy(), one.points.numpy(),
              one.inlier.numpy(), pose_tol, point_tol)


def test_sharded_pose_graph_matches_jax_and_one_rank(problems, ranks,
                                                     jax_out):
    tn, _ = tposegraph.optimize_pose_graph(_tgraph(problems["pg"]),
                                           **PG_ITERS)
    jn = jax_out["pg"]["nodes"]
    nodes = ranks[0]["pg.nodes.0"]
    assert np.linalg.norm(jn - problems["pg"]["nodes"],
                          axis=-1).max() > 10 * PG_TOL
    for ref in (jn, tn.numpy()):
        assert np.linalg.norm(nodes - ref, axis=-1).max() < PG_TOL


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_spawn_fails_on_a_failed_rank():
    """A rank that raises fails the launch (here both: an unknown job)."""
    with pytest.raises(RuntimeError, match="rank exit codes"):
        launch.spawn(launch.solve_worker, 2,
                     ([dict(name="x", kind="bogus", problem={}, n_outer=1,
                            n_cg=1)], "/nonexistent", "cpu", "gloo"),
                     timeout=120)


def test_spawn_kills_ranks_past_their_timeout():
    """Ranks still running at the deadline are killed and the launch
    fails (here they are still starting up)."""
    with pytest.raises(TimeoutError):
        launch.spawn(launch.solve_worker, 2, ([], "/nonexistent", "cpu",
                                              "gloo"), timeout=0.2)


def test_launcher_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    """`python -m orb_slam2_tpu_torch.distributed.launch` without
    `--device` runs on the CUDA cards, and raises before any rank starts
    when there is none; with `--device cpu` its 2 gloo ranks run the
    landmark-sharded BA and agree on the checksum."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(["--nprocs", "2", "--backend", "gloo"])
    assert launch.main(["--nprocs", "2", "--backend", "gloo", "--device",
                        "cpu", "--timeout", "300"]) == 0
    out = capsys.readouterr().out
    assert "multihost run OK" in out
