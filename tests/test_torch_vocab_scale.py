"""Place recognition at the JAX package's at-scale width, the port against
the JAX package on the CPU: the port's counterpart of
tests/test_vocab_scale.py.

One module-scoped ORBvoc text file of test_vocab_scale.py's uniform
k = 10, depth-5 tree (`_synth_vocab`, seed 0: 111,111 nodes, 10^5 words),
written once by the port's writer and parsed by both packages:
- the writers give the same bytes; the native parsers of both packages,
  and the port's plain Python parser, read the same tree;
- the transform of the same seeded descriptors at 10^5 width;
- `detect_loop_candidates` / `detect_reloc_candidates` over one seeded
  256 x 10^5 keyframe table with a planted twin and near twins, whole and
  by chunks of rows;
- a short RGB-D session at test_e2e's 320x240 configuration with
  `VocabConfig(depth=5)` and this tree, in both packages;
- the keyframe BoW table's rows written in place (a copy of a 10^6-wide
  table at each write would be GBs), as JAX's `.at[].set` writes them,
  also from a gathered batch of sequences and under a per-sequence
  select.
Tolerances and their reasons stand in each test.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.io import synthetic
from orb_slam2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_tpu.place import database as jdatabase
from orb_slam2_tpu.place import vocab as jvocab
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.place import database as tdatabase
from orb_slam2_tpu_torch.place import vocab as tvocab

WIDTH = 10 ** 5
N_KF = 256
TWIN = 17
NEAR = (40, 41, 42, 43, 200)        # rows sharing most of the query's words
QUERY_KF = 100
N_SESSION = 10
POSE_ATOL = 1e-3                    # tests/test_torch_session.py's


def _scale_module():
    spec = importlib.util.spec_from_file_location(
        "test_vocab_scale_tree",
        os.path.join(os.path.dirname(__file__), "test_vocab_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """(the JAX tree, its text file, the port's and JAX's parses)."""
    voc = _scale_module()._synth_vocab(np.random.RandomState(0))
    path = str(tmp_path_factory.mktemp("voc") / "ORBvoc_1e5.txt")
    tvocab.save_orbvoc_text(tvocab.Vocabulary(**dataclasses.asdict(voc)),
                            path)
    return dict(voc=voc, path=path,
                t=tvocab.load_orbvoc_text(path, levels_up=2, native=True),
                j=jvocab.load_orbvoc_text(path, levels_up=2))


def _same_tree(a, b):
    for f in ("node_children", "node_desc", "word_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.k, a.depth, a.n_words, a.levels_up) == \
        (b.k, b.depth, b.n_words, b.levels_up)


def test_writers_give_the_same_bytes_at_scale(big, tmp_path):
    """The port's writer lays out its lines with numpy: at 111,111 nodes
    its file is the JAX package's writer's, byte for byte."""
    p = str(tmp_path / "j.txt")
    jvocab.save_orbvoc_text(big["voc"], p)
    with open(p, "rb") as a, open(big["path"], "rb") as b:
        assert a.read() == b.read()


def test_native_parsers_agree_at_scale(big):
    """Both packages' native parsers, and the port's plain Python one, on
    the 111,111-node file: the node tables exactly; weights within rtol
    1e-5, the two parsers' decimal-to-float paths (a digit loop, and
    Python's float then a cast) differing by an ulp at most.  The tree is
    test_vocab_scale.py's."""
    t, j, voc = big["t"], big["j"], big["voc"]
    assert jvocab._native_lib() is not None
    _same_tree(t, j)
    for f in ("node_children", "word_id"):
        np.testing.assert_array_equal(getattr(t, f), getattr(voc, f))
    # the root's centroid is not in the file
    np.testing.assert_array_equal(t.node_desc[1:], voc.node_desc[1:])
    np.testing.assert_allclose(t.word_weight, j.word_weight, rtol=1e-5)
    np.testing.assert_allclose(t.word_weight, voc.word_weight, rtol=1e-5)
    py = tvocab.load_orbvoc_text(big["path"], levels_up=2, native=False)
    _same_tree(py, t)
    np.testing.assert_allclose(py.word_weight, t.word_weight, rtol=1e-5)
    assert t.n_words == WIDTH and t.node_children.shape[0] == 111111
    # the same file cut at depth 4 (10^4 words), as both packages cut it
    t4 = tvocab.load_orbvoc_text(big["path"], levels_up=2, truncate_depth=4)
    j4 = jvocab.load_orbvoc_text(big["path"], levels_up=2, truncate_depth=4)
    _same_tree(t4, j4)
    np.testing.assert_allclose(t4.word_weight, j4.word_weight, rtol=1e-5)


def _descriptors(seed, n=500):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 32)).astype(np.uint8)


def test_transform_at_scale_matches_jax(big):
    """The 5-level descent and the BoW vector at 10^5 width on 500 seeded
    descriptors (a tenth invalid): words and the levels-up nodes exactly
    (integer argmaxes of exact +-1 sums in both), the BoW within 1e-6 (JAX
    sums the weights of a word's descriptors, the port multiplies its
    count by the weight: the two differ by a few ulps of ~1e-3 entries)."""
    d = _descriptors(1)
    valid = np.arange(500) % 10 != 3
    jb, jw, jn = jvocab.build_transform(big["j"], pad_to=WIDTH)(
        jnp.asarray(d), jnp.asarray(valid))
    tb, tw, tn = tvocab.build_transform(big["t"], pad_to=WIDTH,
                                        device="cpu")(
        torch.from_numpy(d), torch.from_numpy(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tb.shape == (WIDTH,) and (tb > 0).sum() >= 100
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def table(big):
    """A seeded 256 x 10^5 keyframe BoW table as tests/test_vocab_scale.py
    builds it (300 random words a row, L1-normalised), the query (the
    transform of seeded descriptors) planted at TWIN, rows NEAR sharing
    100% down to 85% of the query's words at perturbed values, and
    covisibility links that group the twin with a near twin and the near
    twins with each other."""
    rng = np.random.RandomState(2)
    q = tvocab.build_transform(big["t"], pad_to=WIDTH, device="cpu")(
        torch.from_numpy(_descriptors(3)), torch.ones(500, dtype=torch.bool)
    )[0].numpy()
    kf = np.zeros((N_KF, WIDTH), np.float32)
    for i in range(N_KF):
        idx = rng.randint(0, WIDTH, 300)
        kf[i, idx] = rng.rand(300).astype(np.float32)
    nz = np.nonzero(q)[0]
    for r, keep in zip(NEAR, (1.0, 0.97, 0.93, 0.9, 0.85)):
        kf[r] = 0
        sel = nz[rng.rand(len(nz)) < keep]
        kf[r, sel] = q[sel] * (0.5 + rng.rand(len(sel))).astype(np.float32)
    kf /= kf.sum(1, keepdims=True)
    kf[TWIN] = q
    covis = np.zeros((N_KF, N_KF), np.int32)
    pairs = [(TWIN, 40, 40), (40, 41, 30), (41, 42, 20), (43, 200, 25),
             (5, 6, 50), (QUERY_KF, 3, 60)]
    for a, b, w in pairs:
        covis[a, b] = covis[b, a] = w
    valid = np.ones(N_KF, bool)
    valid[7] = False
    return dict(q=q, kf=kf, covis=covis, valid=valid)


def _port_detect(tb, query):
    args = (torch.from_numpy(tb["kf"]), torch.from_numpy(tb["valid"]),
            torch.from_numpy(tb["covis"]))
    q = torch.from_numpy(tb["q"])
    loop = tdatabase.detect_loop_candidates(
        *args, torch.tensor(query), q, torch.tensor(0.01))
    reloc = tdatabase.detect_reloc_candidates(*args, q)
    return loop, reloc


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["one_call", "by_rows"])
def test_detection_at_scale_matches_jax(table, monkeypatch, chunked):
    """Loop candidates for a query keyframe (QUERY_KF) and relocalisation
    candidates for the query vector, over the 256 x 10^5 table: the ids
    equal JAX's, the scores within 1e-5 (a 10^5-term f32 sum of |a - b|
    in another order: ~1e-7 relative, well under the gaps between the
    planted rows' scores), the twin among them.  "by_rows" scores the
    table 7 rows at a time (`SCORE_CHUNK_BYTES`), as the plain version of
    `table_scores` gathers them at 10^6 words: the same ids and the same
    scores bit for bit."""
    args = (jnp.asarray(table["kf"]), jnp.asarray(table["valid"]),
            jnp.asarray(table["covis"]))
    q = jnp.asarray(table["q"])
    jl = jdatabase.detect_loop_candidates(*args, jnp.asarray(QUERY_KF), q,
                                          jnp.asarray(0.01))
    jr = jdatabase.detect_reloc_candidates(*args, q)
    whole = _port_detect(table, QUERY_KF)
    if chunked:
        monkeypatch.setattr(tvocab, "SCORE_CHUNK_BYTES", 7 * WIDTH * 4)
    tl, tr = _port_detect(table, QUERY_KF)
    for t, j, w in ((tl, jl, whole[0]), (tr, jr, whole[1])):
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        fin = np.isfinite(np.asarray(j.scores))
        np.testing.assert_array_equal(np.isfinite(t.scores.numpy()), fin)
        np.testing.assert_allclose(t.scores.numpy()[fin],
                                   np.asarray(j.scores)[fin], rtol=0,
                                   atol=1e-5)
        assert torch.equal(t.ids, w.ids) and torch.equal(t.scores, w.scores)
        assert TWIN in t.ids.tolist()
    assert len(set(tr.ids.tolist()) - {-1}) >= 2
    # the scores by rows, against whole-table arithmetic
    kf, qt = torch.from_numpy(table["kf"]), torch.from_numpy(table["q"])
    l1 = tvocab.l1_score(qt[None], kf)
    assert torch.equal(l1, 1.0 - 0.5 * torch.sum(torch.abs(qt[None] - kf),
                                                 dim=-1))
    assert torch.equal(tvocab.shared_words(qt[None], kf), torch.sum(
        (qt[None] > 0) & (kf > 0), dim=-1).to(torch.int32))


def _session_cfg(m):
    """test_e2e's small RGB-D configuration with 10^5-word BoW rows and a
    small keyframe capacity (32: loop detection takes 30 neighbours)."""
    cam = m.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                         height=240, fps=30.0, bf=16.0, th_depth=35.0)
    return m.SLAMConfig(
        sensor=m.RGBD, camera=cam,
        orb=m.ORBConfig(n_features=500, max_keypoints=512),
        vocab=m.VocabConfig(depth=5),
        cap=m.Capacity(max_keyframes=32, max_points=6144, max_obs_per_kf=512,
                       max_frames=64, local_ba_points=2048))


@pytest.fixture(scope="module")
def sessions(big, tmp_path_factory):
    cam = _session_cfg(jconfig).camera
    seq = synthetic.generate(cam, n_frames=N_SESSION, n_points=300,
                             trajectory="xyz", seed=0)
    npz = str(tmp_path_factory.mktemp("npz") / "vocab_1e5.npz")
    big["t"].save(npz)
    out = {}
    for name, slam in (("jax", JSLAM(_session_cfg(jconfig), vocab_path=npz)),
                       ("port", tsystem.SLAM(_session_cfg(tconfig),
                                             device="cpu", vocab_path=npz))):
        for f in range(N_SESSION):
            slam.track_rgbd(seq.images[f], seq.depths[f], seq.timestamps[f])
        slam.flush()
        out[name] = slam
    return out


def test_rgbd_session_at_1e5_words_matches_jax(sessions):
    """A 10-frame RGB-D session in both packages with the 10^5-word tree:
    every frame tracked in both, the same keyframes, poses within
    POSE_ATOL (tests/test_torch_session.py: pose LMs summing residuals in
    another order drift the packages ~1e-5 m apart), and each keyframe's
    BoW row within 1e-6 of JAX's (the transform's tolerance above: the
    keyframes' descriptors are the same, the images being the same)."""
    j, t = sessions["jax"], sessions["port"]
    jp, tp = j.poses_twc(), t.poses_twc()
    assert tp.shape == jp.shape == (N_SESSION, 7)
    flip = np.sum(tp[:, :4] * jp[:, :4], axis=1) < 0
    tp = np.where(flip[:, None], np.concatenate([-tp[:, :4], tp[:, 4:]], 1),
                  tp)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_ATOL)
    kv = np.asarray(j.state.kf_valid)
    np.testing.assert_array_equal(t.state.kf_valid.numpy(), kv)
    np.testing.assert_array_equal(t.state.kf_frame_id.numpy(),
                                  np.asarray(j.state.kf_frame_id))
    assert kv.sum() >= 2
    tb, jb = t.state.kf_bow.numpy(), np.asarray(j.state.kf_bow)
    assert tb.shape == jb.shape == (32, WIDTH)
    assert (np.abs(tb[kv].sum(1) - 1) < 1e-3).all()
    np.testing.assert_array_equal(tb[kv] > 0, jb[kv] > 0)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the BoW table's rows, written in place
# ---------------------------------------------------------------------------

def _stacked_table(S=4, K=6, W=50):
    rng = np.random.RandomState(4)
    return (rng.rand(S, K, W).astype(np.float32),
            rng.randint(0, K, S), rng.rand(S, W).astype(np.float32))


def test_bow_rows_written_in_place_match_jax():
    """`seq_put_row_` on a stacked [S, K, W] table: sequence s's row k[s]
    set where on[s] holds, as JAX's `.at[s, k[s]].set` selected per
    sequence, exactly (a copy of values); the table written in place."""
    from orb_slam2_tpu_torch.map.state import seq_put_row_
    table, k, v = _stacked_table()
    on = np.array([True, False, True, True])
    j = jnp.asarray(table).at[np.arange(4), k].set(jnp.asarray(v))
    j = jnp.where(jnp.asarray(on)[:, None, None], j, jnp.asarray(table))
    t = torch.from_numpy(table.copy())
    out = seq_put_row_(t, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(on))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # a scalar clears the rows, as the culled keyframe's row is cleared
    seq_put_row_(t, torch.from_numpy(k), 0.0, None)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(j.at[np.arange(4), k].set(0.0)))


def test_a_batch_of_sequences_keeps_its_in_place_row_writes():
    """`system.on_sequences` runs a stage group on a gathered batch of the
    sequences at it (2 of 4 here: a batch of 2); a BoW row the group
    writes in place into the gathered copy, as the cull stage clears a
    culled keyframe's row, is put back into the table, and only those
    sequences' rows change."""
    table, k, v = _stacked_table()
    on = torch.tensor([False, True, False, True])
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)

    def fn(bow, rows, vals, sel):
        from orb_slam2_tpu_torch.map.state import seq_put_row_
        seq_put_row_(bow, rows, vals, sel)
        return bow, rows, vals

    got = tsystem.on_sequences(on, fn, (torch.from_numpy(table.copy()), kt,
                                        vt))[0]
    want = table.copy()
    for s in (1, 3):
        want[s, k[s]] = v[s]
    np.testing.assert_array_equal(got.numpy(), want)


def test_set_bow_under_a_false_mask_leaves_the_row_unchanged():
    """`system.set_bow` writes in place, so `seq_where(on, new, old)` cannot
    undo its write for a sequence: it takes the mask itself.  Under
    `seq_where` over a stacked MapState of 3 sequences, the masked-out
    sequence's row keeps its values and the others' are written, as JAX's
    functional write selected per sequence gives."""
    from orb_slam2_tpu_torch.map.state import empty_map, seq_where
    S, K, W = 3, 4, 100
    cfg = tconfig.SLAMConfig(vocab=tconfig.VocabConfig(depth=2))
    one = empty_map(cfg.replace(cap=dataclasses.replace(
        cfg.cap, max_keyframes=K)), "cpu")
    rng = np.random.RandomState(5)
    old_bow = rng.rand(S, K, W).astype(np.float32)
    state = type(one)(*(torch.stack([x] * S) for x in one))._replace(
        kf_bow=torch.from_numpy(old_bow.copy()))
    k = torch.tensor([1, 2, 3])
    bow = torch.from_numpy(rng.rand(S, W).astype(np.float32))
    on = torch.tensor([True, False, True])
    out = seq_where(on, tsystem.set_bow(state, k, bow, on), state)
    want = old_bow.copy()
    for s in (0, 2):
        want[s, k[s]] = bow[s].numpy()
    np.testing.assert_array_equal(out.kf_bow.numpy(), want)
