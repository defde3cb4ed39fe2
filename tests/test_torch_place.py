"""Parity of the port's place recognition and loop-closing solvers with the
JAX package on the CPU, on the same numpy-seeded inputs.

* vocabulary: one vocabulary (the JAX package's default, carried across
  with `convert.vocabulary_from_numpy`) turns the same descriptors into the
  same words and tree nodes (an argmax over exact integer dot products,
  first index on ties) and BoW vectors within 1e-6 (each entry is
  count x weight here and a float sum of the weight there, then both are
  L1-normalized); the port's data file is the JAX one, byte for byte.
* keyframe database: the same loop and relocalisation candidates (the
  ranking is `lax.top_k`'s, ties towards the lower index) with scores
  within 1e-6.
* EPnP RANSAC and Sim3 RANSAC get JAX's own sample sets: the same inlier
  sets, and poses within 1e-3 (the null vectors come from `eigh`, whose
  signs and solvers differ; the pose does not depend on them).
* optimize_sim3 and optimize_pose_graph: LMs over sums taken in another
  order; the results agree to 1e-4.  Both run with a free scale, as on the
  monocular path.

The relocalisation step, loop verification and correction and the
post-loop GBA merge are held against JAX on a carried SLAM state in
tests/test_torch_slam.py, which already runs that JAX session.
"""

import dataclasses
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ba import posegraph as jpg
from orb_slam2_tpu.core import camera as jcam
from orb_slam2_tpu.core import lie as jlie
from orb_slam2_tpu.place import database as jdb
from orb_slam2_tpu.place import vocab as jvocab
from orb_slam2_tpu.solvers import epnp as jepnp
from orb_slam2_tpu.solvers import sim3 as jsim3
from orb_slam2_tpu.solvers import twoview as jtv
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ba import posegraph as tpg
from orb_slam2_tpu_torch.place import database as tdb
from orb_slam2_tpu_torch.place import vocab as tvocab
from orb_slam2_tpu_torch.solvers import epnp as tepnp
from orb_slam2_tpu_torch.solvers import sim3 as tsim3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VOCAB = os.path.join(ROOT, "orb_slam2_tpu", "data", "vocab_default.npz")
PORT_VOCAB = os.path.join(ROOT, "orb_slam2_tpu_torch", "data",
                          "vocab_default.npz")
K = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_pose(a, b, atol):
    """SE3 / Sim3 rows equal up to the quaternion's sign."""
    a, b = np.asarray(a), np.asarray(b)
    q = a[:4] if np.dot(a[:4], b[:4]) >= 0 else -a[:4]
    np.testing.assert_allclose(q, b[:4], rtol=0, atol=atol)
    np.testing.assert_allclose(a[4:], b[4:], rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

def test_port_vocabulary_file_is_the_jax_one():
    assert filecmp.cmp(JAX_VOCAB, PORT_VOCAB, shallow=False)


@pytest.fixture(scope="module")
def vocabs():
    jv = jvocab.Vocabulary.load(JAX_VOCAB)
    return jv, convert.vocabulary_from_numpy(dataclasses.asdict(jv))


def test_vocabulary_save_load_roundtrip(vocabs, tmp_path):
    _, tv = vocabs
    tv.save(str(tmp_path / "v.npz"))
    back = tvocab.Vocabulary.load(str(tmp_path / "v.npz"))
    for f in dataclasses.fields(tv):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(tv, f.name), err_msg=f.name)


@pytest.mark.parametrize("pad", [None, 10 ** 4])
def test_transform_matches_jax(vocabs, pad):
    jv, tv = vocabs
    rng = np.random.RandomState(0)
    desc = rng.randint(0, 256, (300, 32)).astype(np.uint8)
    # near-copies of centroids: descents that pass close to the tree
    desc[:100] = jv.node_desc[rng.randint(1, jv.node_desc.shape[0], 100)]
    valid = rng.rand(300) < 0.9
    jb, jw, jl = jvocab.build_transform(jv, pad_to=pad)(
        jnp.asarray(desc), jnp.asarray(valid))
    tb, tw, tl = tvocab.build_transform(tv, pad_to=pad, device="cpu")(
        _t(desc), _t(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tb.shape == jb.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    assert abs(float(tb.sum()) - 1.0) < 1e-5


def test_scores_match_jax():
    rng = np.random.RandomState(1)
    a = (rng.rand(64) * (rng.rand(64) < 0.3)).astype(np.float32)
    b = (rng.rand(5, 64) * (rng.rand(5, 64) < 0.3)).astype(np.float32)
    a, b = a / a.sum(), b / b.sum(1, keepdims=True)
    np.testing.assert_allclose(tvocab.l1_score(_t(a)[None], _t(b)).numpy(),
                               np.asarray(jvocab.l1_score(a[None], b)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tvocab.shared_words(_t(a)[None], _t(b)).numpy(),
        np.asarray(jvocab.shared_words(a[None], b)))


# ---------------------------------------------------------------------------
# keyframe database
# ---------------------------------------------------------------------------

def _db(seed, K_=40, W=300):
    """Keyframes along a path: neighbours share words, every fifth one
    revisits an early place; covisibility between temporal neighbours."""
    rng = np.random.RandomState(seed)
    base = rng.rand(K_, W) * (rng.rand(K_, W) < 0.08)
    for k in range(1, K_):
        base[k] += 0.6 * base[k - 1]
    for k in range(20, K_, 5):
        base[k] += base[k - 18]
    bow = (base / base.sum(1, keepdims=True)).astype(np.float32)
    valid = rng.rand(K_) < 0.9
    covis = np.zeros((K_, K_), np.int32)
    for k in range(K_ - 1):
        w = rng.randint(5, 120)
        covis[k, k + 1] = covis[k + 1, k] = w
        if k + 2 < K_:
            covis[k, k + 2] = covis[k + 2, k] = w // 3
    return bow, valid, covis


@pytest.mark.parametrize("seed", [0, 1])
def test_loop_and_reloc_candidates_match_jax(seed):
    bow, valid, covis = _db(seed)
    q = 35
    valid[q] = True
    for n_out in (4, 8, 64):
        j = jdb.detect_loop_candidates(
            jnp.asarray(bow), jnp.asarray(valid), jnp.asarray(covis),
            jnp.asarray(q), jnp.asarray(bow[q]), jnp.asarray(0.05),
            n_out=n_out)
        t = tdb.detect_loop_candidates(
            _t(bow), _t(valid), _t(covis), q, _t(bow[q]),
            torch.tensor(0.05), n_out=n_out)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                                   rtol=0, atol=1e-6)
        assert (t.ids.numpy() >= 0).any()
        qb = (bow[q] + 0.3 * bow[7]) / 1.3
        j = jdb.detect_reloc_candidates(
            jnp.asarray(bow), jnp.asarray(valid), jnp.asarray(covis),
            jnp.asarray(qb), n_out=n_out)
        t = tdb.detect_reloc_candidates(_t(bow), _t(valid), _t(covis),
                                        _t(qb), n_out=n_out)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [None, 3], ids=["one_call", "by_3"])
def test_table_scores_plain_matches_l1_and_shared(monkeypatch, chunk_rows):
    """`table_scores` on CPU tensors: on every listed row (repeats and
    out-of-order ids included) the bits of `l1_score` and `shared_words`
    over the whole table, also when the listed rows are gathered 3 at a
    time; 0 and 0 on a skipped row (-1, or an id past the table)."""
    bow, _, _ = _db(3, K_=20, W=1000)
    table = _t(bow)
    q = table[4] * 0.5 + table[11] * 0.5
    rows = _t(np.array([5, -1, 0, 19, 5, 20, 11, -1, 4, 2], np.int64))
    if chunk_rows is not None:
        monkeypatch.setattr(tvocab, "SCORE_CHUNK_BYTES",
                            chunk_rows * table.shape[1] * 4)
    score, shared = tvocab.table_scores(q, table, rows)
    assert score.dtype == torch.float32 and shared.dtype == torch.int32
    listed = (rows >= 0) & (rows < table.shape[0])
    ids = rows[listed]
    assert torch.equal(score[listed],
                       tvocab.l1_score(q[None], table)[ids])
    assert torch.equal(shared[listed],
                       tvocab.shared_words(q[None], table)[ids])
    assert (score[~listed] == 0).all() and (shared[~listed] == 0).all()
    # int32 ids and an empty list
    assert torch.equal(tvocab.table_scores(q, table, rows.int())[0], score)
    s0, c0 = tvocab.table_scores(q, table, rows[:0])
    assert s0.shape == c0.shape == (0,)


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_never_reads_skipped_rows(seed):
    """Loop and relocalisation candidates and `loopclosing.detect`'s
    min-score rows: filling the rows that detection skips (invalid
    keyframes; for loops also the query and its connected keyframes) with
    random non-zero BoW changes neither the ids nor the scores, bit for
    bit."""
    bow, valid, covis = _db(seed)
    q = 35
    valid[q] = True
    rng = np.random.RandomState(10 + seed)
    skipped = ~valid.copy()
    skipped[q] = True
    skipped |= covis[q] >= 15
    noisy = bow.copy()
    noisy[skipped] = rng.rand(int(skipped.sum()), bow.shape[1]).astype(
        np.float32) + 0.1
    noisy_reloc = bow.copy()
    noisy_reloc[~valid] = noisy[~valid]
    qb = _t((bow[q] + 0.3 * bow[7]) / 1.3)
    for table, reloc_table in ((bow, bow), (noisy, noisy_reloc)):
        loop = tdb.detect_loop_candidates(
            _t(table), _t(valid), _t(covis), q, _t(bow[q]),
            torch.tensor(0.05))
        reloc = tdb.detect_reloc_candidates(_t(reloc_table), _t(valid),
                                            _t(covis), qb)
        if table is bow:
            first = (loop, reloc)
            assert (loop.ids >= 0).any() and (reloc.ids >= 0).any()
        else:
            for a, b in zip((loop, reloc), first):
                assert torch.equal(a.ids, b.ids)
                assert torch.equal(a.scores, b.scores)
    # the min-score scoring of `loopclosing.detect`: the -1 neighbours
    nb = _t(np.array([3, 9, -1, -1], np.int64))
    got = [tvocab.table_scores(_t(bow[q]), _t(t), nb)
           for t in (bow, np.where(np.arange(len(bow))[:, None] < 3, 5.0,
                                   bow).astype(np.float32))]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


# ---------------------------------------------------------------------------
# EPnP, Sim3, pose graph
# ---------------------------------------------------------------------------

def _pnp_scene(n, seed, n_bad):
    rng = np.random.RandomState(seed)
    pw = (rng.randn(n, 3) * [2, 2, 1] + [0, 0, 6]).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.15, 0.1, -0.05,
                                             0.08])))
    uv = np.asarray(jcam.project(jnp.asarray(K), jlie.se3_apply(
        jnp.asarray(T), jnp.asarray(pw))))
    uv = (uv + rng.randn(n, 2) * 0.5).astype(np.float32)
    bad = rng.choice(n, n_bad, replace=False)
    uv[bad] += (rng.randn(n_bad, 2) * 80 + 30).astype(np.float32)
    return pw, uv, T


def test_epnp_solve_matches_jax():
    """One weighted solve (the RANSAC refinement's form; the unweighted
    form runs on every sample in test_pnp_ransac_with_jax_samples)."""
    pw, uv, T = _pnp_scene(80, 1, 0)
    w = (np.random.RandomState(1).rand(80) < 0.8).astype(np.float32)
    j = jax.jit(jepnp.epnp_solve)(jnp.asarray(pw), jnp.asarray(uv),
                                  jnp.asarray(K), jnp.asarray(w))
    t = tepnp.epnp_solve(_t(pw), _t(uv), _t(K), _t(w))
    _same_pose(t.numpy(), j, 1e-3)
    _same_pose(t.numpy(), T, 2e-2)


def test_pnp_ransac_with_jax_samples():
    n = 100
    pw, uv, T = _pnp_scene(n, 1, 35)
    valid = np.random.RandomState(3).rand(n) < 0.95
    key = jax.random.PRNGKey(0)
    sets = np.asarray(jtv._sample_sets(key, jnp.asarray(valid), 64, 6))
    gate = np.full(n, 5.991, np.float32)
    j = jax.jit(functools.partial(jepnp.pnp_ransac, iters=64))(
        key, jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
        jnp.asarray(K), jnp.asarray(gate))
    t = tepnp.pnp_ransac(_t(sets), _t(pw), _t(uv), _t(valid), _t(K),
                         _t(gate))
    assert bool(t.ok) and bool(j.ok)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 50
    _same_pose(t.T.numpy(), j.T, 1e-3)


def _sim3_pair(n, seed, n_bad=0, noise=0.0):
    rng = np.random.RandomState(seed)
    S_true = jnp.concatenate([jlie.quat_normalize(jnp.asarray(
        [0.98, 0.05, -0.1, 0.08])), jnp.asarray([0.3, -0.1, 0.2, 0.8])])
    p2 = (rng.randn(n, 3) * [1.5, 1.5, 0.5] + [0, 0, 5]).astype(np.float32)
    p1 = np.array(jlie.sim3_apply(S_true[None], jnp.asarray(p2)))
    bad = rng.choice(n, n_bad, replace=False)
    p1[bad] += (rng.randn(n_bad, 3) * 2).astype(np.float32)
    uv1 = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(p1)))
    uv2 = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(p2)))
    uv1 = (uv1 + rng.randn(n, 2) * noise).astype(np.float32)
    uv2 = (uv2 + rng.randn(n, 2) * noise).astype(np.float32)
    return p1.astype(np.float32), p2, uv1, uv2, np.asarray(S_true)


def test_sim3_ransac_with_jax_samples(fix_scale=False):
    n = 60
    p1, p2, uv1, uv2, _ = _sim3_pair(n, 2, n_bad=20)
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(1)
    sets = np.asarray(jtv._sample_sets(key, jnp.asarray(valid), 128, 3))
    gate = np.full(n, 9.21, np.float32)
    args = (p1, p2, uv1, uv2, valid, K, gate, gate)
    j = jax.jit(functools.partial(jsim3.sim3_ransac, fix_scale=fix_scale))(
        key, *[jnp.asarray(a) for a in args])
    t = tsim3.sim3_ransac(_t(sets), *[_t(a) for a in args],
                          fix_scale=fix_scale)
    assert bool(t.ok) == bool(j.ok)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    _same_pose(t.S12.numpy(), j.S12, 1e-3)


def test_optimize_sim3_matches_jax(fix_scale=False):
    n = 50
    p1, p2, uv1, uv2, S_true = _sim3_pair(n, 3, noise=0.3)
    S0 = np.asarray(jlie.sim3_retract(jnp.asarray(S_true), jnp.asarray(
        [0.05, -0.03, 0.02, 0.02, -0.01, 0.03, 0.05], np.float32)))
    valid = np.random.RandomState(4).rand(n) < 0.9
    inv = np.ones(n, np.float32)
    args = (S0, p1, p2, uv1, uv2, valid, K, inv, inv)
    # 4 LM steps: the mid-way outlier rejection falls after the third
    jS, jn, jinl = jax.jit(functools.partial(
        jsim3.optimize_sim3, fix_scale=fix_scale, iters=4))(
        *[jnp.asarray(a) for a in args])
    tS, tn, tinl = tsim3.optimize_sim3(*[_t(a) for a in args],
                                       fix_scale=fix_scale, iters=4)
    _same_pose(tS.numpy(), jS, 1e-4)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))


def _ring(n=10, seed=0, fix_scale=False):
    """Odometry ring with drift and one loop edge, plus one inactive edge."""
    rng = np.random.RandomState(seed)
    gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        q = jlie.so3_exp(jnp.asarray([0.0, ang, 0.0]))
        t = jnp.asarray([np.cos(ang) * 3, 0.0, np.sin(ang) * 3], jnp.float32)
        gt.append(jlie.sim3_from_se3(jlie.se3(q, t)))
    est, ei, ej, meas = [gt[0]], [], [], []
    for i in range(n - 1):
        m = jlie.sim3_compose(gt[i + 1], jlie.sim3_inverse(gt[i]))
        ei.append(i)
        ej.append(i + 1)
        meas.append(m)
        noise = jnp.asarray(np.concatenate([
            rng.randn(3) * 0.03, rng.randn(3) * 0.015,
            [0.0 if fix_scale else rng.randn() * 0.01]]), jnp.float32)
        est.append(jlie.sim3_compose(jlie.sim3_compose(
            jlie.sim3_exp(noise), m), est[-1]))
    ei += [n - 1, 2]
    ej += [0, 5]
    meas += [jlie.sim3_compose(gt[0], jlie.sim3_inverse(gt[n - 1])), meas[0]]
    w = np.ones(len(ei), np.float32)
    w[-1] = 0.0
    return dict(nodes=np.asarray(jnp.stack(est)), node_valid=np.ones(n, bool),
                node_fixed=np.arange(n) == 0,
                edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32),
                edge_meas=np.asarray(jnp.stack(meas)), edge_w=w)


def test_optimize_pose_graph_matches_jax(fix_scale=False):
    f = _ring(fix_scale=fix_scale)
    jn, jc = jax.jit(functools.partial(jpg.optimize_pose_graph, n_outer=4,
                                       n_cg=12))(jpg.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in f.items()},
        fix_scale=jnp.asarray(fix_scale)))
    tn, tc = tpg.optimize_pose_graph(tpg.PoseGraphProblem(
        **{k: _t(v) for k, v in f.items()}, fix_scale=fix_scale),
        n_outer=4, n_cg=12)
    for a, b in zip(tn.numpy(), np.asarray(jn)):
        _same_pose(a, b, 1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3,
                               atol=1e-6)
    assert float(tc[-1]) < 0.1 * float(tc[0])
