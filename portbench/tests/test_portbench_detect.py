"""The detection comparison: the reference's loop candidates against the
program's `loopclosing.detect` on a seeded keyframe table with planted
near-twins of the query, and `correct`'s numbers under a fault and under
the bfloat16 control."""

import types

import numpy as np
import pytest
import torch

from portbench import check, reference

K, W = 48, 300
QUERY = 0
TWINS = ((20, 1.0), (21, 0.9), (22, 0.85), (35, 0.95), (36, 0.9),
         (37, 0.88))
GROUPS = ((20, 21, 22), (35, 36, 37))


def table(seed=3):
    """Sparse rows (words, L1-normalised values), the dense table, valid
    and covisibility: the query's neighbours 1-4 (weight 30), the twins'
    groups covisible in a chain (weight 40), random light links."""
    rng = np.random.RandomState(seed)
    dense = np.zeros((K, W))
    for k in range(K):
        w = rng.choice(W, 40, replace=False)
        dense[k, w] = rng.rand(40) + 0.1
    for k, share in TWINS:
        keep = np.nonzero(dense[QUERY])[0]
        keep = keep[:int(round(share * len(keep)))]
        dense[k] = 0
        dense[k, keep] = dense[QUERY, keep] * (1 + 0.05 * rng.rand(len(keep)))
    dense /= dense.sum(1, keepdims=True)
    covis = rng.randint(0, 10, (K, K))
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    for k in (1, 2, 3, 4):
        covis[QUERY, k] = covis[k, QUERY] = 30
    for g in GROUPS:
        for a, b in zip(g, g[1:]):
            covis[a, b] = covis[b, a] = 40
    valid = np.ones(K, bool)
    valid[K - 1] = False
    rows = [(np.nonzero(r)[0], r[np.nonzero(r)[0]]) for r in dense]
    return rows, dense.astype(np.float32), valid, covis.astype(np.int32)


def program_detect(dense, valid, covis, query):
    from orb_slam2_tpu_torch import config as C
    from orb_slam2_tpu_torch.pipeline import loopclosing
    from orb_slam2_tpu_torch.place import database
    st = types.SimpleNamespace(kf_bow=torch.as_tensor(dense),
                               kf_valid=torch.as_tensor(valid),
                               covis=torch.as_tensor(covis),
                               next_kf=torch.tensor(K))
    cfg = C.SLAMConfig()
    res = database.detect_loop_candidates(
        st.kf_bow, st.kf_valid, st.covis, query, st.kf_bow[query],
        _min_score(st, query), n_out=8,
        shared_frac=cfg.loop.shared_word_frac, acc_frac=cfg.loop.acc_score_frac)
    ids, _ = loopclosing.detect(st, query, cfg)
    assert torch.equal(ids, res.ids)
    return {int(i): float(s) for i, s in zip(res.ids, res.scores) if i >= 0}


def _min_score(st, q):
    from orb_slam2_tpu_torch.map.state import covisible_neighbors
    from orb_slam2_tpu_torch.place.vocab import l1_score
    nb = covisible_neighbors(st, q, 30, min_weight=15)
    s = l1_score(st.kf_bow[q][None, :], st.kf_bow[nb.clamp(min=0)])
    return torch.amin(torch.where(nb >= 0, s, 1.0))


def test_reference_finds_the_programs_candidates():
    rows, dense, valid, covis = table()
    tab = {"valid": valid, "covis": covis, "rows": rows,
           "detect": {QUERY: program_detect(dense, valid, covis, QUERY)}}
    ref = check.detections(tab, rows)
    assert ref[QUERY]["margin"] > check.DETECT_TIE
    assert set(ref[QUERY]["ids"]) == {20, 35}
    det = check.detection_numbers(tab["detect"], ref)
    assert det["detect_miss"] == 0
    c = det["counts"]
    assert (c["compared"], c["tied"], c["with_candidates"]) == (1, 0, 1)
    assert c["score_gap"] < 1e-6


def test_fault_and_control_fail_the_limits():
    rows, dense, valid, covis = table()
    ref = check.detections({"valid": valid, "covis": covis, "rows": rows,
                            "detect": {QUERY: None}}, rows)
    # an answer altered where produced: the program keeps no candidate
    none = check.detection_numbers({QUERY: {}}, ref)
    assert none["detect_miss"] == 1
    # a score altered where produced
    off = {i: v + 1e-3 for i, v in ref[QUERY]["ids"].items()}
    assert check.detection_numbers({QUERY: off}, ref)["detect_miss"] == 1
    # the reference in bfloat16 in the program's place
    low = [(w, torch.as_tensor(v).to(torch.bfloat16).double().numpy())
           for w, v in rows]
    tab = {"valid": valid, "covis": covis, "rows": low,
           "detect": {QUERY: None}}
    got = {q: r["ids"] for q, r in
           check.detections(tab, low, torch.bfloat16).items()}
    det = check.detection_numbers(got, ref)
    assert det["counts"]["score_gap"] > 1e-4, det
    assert det["detect_miss"] == 1


def test_a_query_decided_at_a_tie_is_left_out():
    rows, dense, valid, covis = table()
    ref = check.detections({"valid": valid, "covis": covis, "rows": rows,
                            "detect": {QUERY: None}}, rows)
    ref[QUERY]["margin"] = check.DETECT_TIE / 2
    det = check.detection_numbers({QUERY: {}}, ref)
    assert det["detect_miss"] == 0
    assert det["counts"]["tied"] == 1


@pytest.mark.parametrize("share", [1.0, 0.5])
def test_sparse_rows_score_as_dense(share):
    rows, dense, valid, covis = table()
    a, b = rows[QUERY], rows[20 if share == 1.0 else 7]
    s, n = reference.l1_score(a, b)
    va, vb = dense[QUERY].astype(np.float64), dense[
        20 if share == 1.0 else 7].astype(np.float64)
    assert s == pytest.approx(1 - 0.5 * np.abs(va - vb).sum(), abs=1e-6)
    assert n == int(((va > 0) & (vb > 0)).sum())
