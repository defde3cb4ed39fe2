"""Parity of the port's matching/ with the JAX package on the CPU.

Hamming distances are integers, exact on both sides (and against a numpy
popcount).  The matchers' outputs are integer indices chosen by integer
distances, window and octave gates on f32 coordinates and an angle
histogram, so the match indices must be equal, not close.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.matching import hamming as jham
from orb_slam2_tpu.matching import search as jsearch
from orb_slam2_tpu_torch.matching import hamming as tham
from orb_slam2_tpu_torch.matching import search as tsearch


def _popcount_dist(a, b):
    x = np.unpackbits(a, axis=1)[:, None, :] != np.unpackbits(b, axis=1)[None]
    return x.sum(-1).astype(np.int32)


def _scene(seed, n_b=300, n_a=200):
    """Keypoints B and queries A: 2/3 of A are noisy copies of a B keypoint
    (a few flipped bits, a small shift in position and angle), the rest
    random."""
    rng = np.random.RandomState(seed)
    desc_b = rng.randint(0, 256, (n_b, 32)).astype(np.uint8)
    uv_b = (rng.rand(n_b, 2) * [320, 240]).astype(np.float32)
    ang_b = (rng.rand(n_b) * 2 * np.pi - np.pi).astype(np.float32)
    oct_b = rng.randint(0, 4, n_b).astype(np.int32)
    src = rng.choice(n_b, n_a, replace=False)
    bits = np.unpackbits(desc_b[src], axis=1)
    flip = rng.rand(*bits.shape) < rng.choice([0.02, 0.1, 0.5], (n_a, 1))
    desc_a = np.packbits(bits ^ flip, axis=1)
    uv_a = (uv_b[src] + rng.randn(n_a, 2) * 3).astype(np.float32)
    ang_a = (ang_b[src] + 0.3 + rng.randn(n_a) * 0.05).astype(np.float32)
    oct_a = oct_b[src].copy()
    rnd = rng.rand(n_a) < 1 / 3
    desc_a[rnd] = rng.randint(0, 256, (rnd.sum(), 32))
    uv_a[rnd] = (rng.rand(rnd.sum(), 2) * [320, 240]).astype(np.float32)
    valid_a = rng.rand(n_a) < 0.95
    valid_b = rng.rand(n_b) < 0.95
    return dict(desc_a=desc_a, desc_b=desc_b, uv_a=uv_a, uv_b=uv_b,
                ang_a=ang_a, ang_b=ang_b, oct_a=oct_a, oct_b=oct_b,
                valid_a=valid_a, valid_b=valid_b)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_hamming_matrix_and_rows_exact():
    s = _scene(0)
    ref = _popcount_dist(s["desc_a"], s["desc_b"])
    t = tham.hamming_matrix(_t(s["desc_a"]), _t(s["desc_b"])).numpy()
    j = np.asarray(jham.hamming_matrix(_j(s["desc_a"]), _j(s["desc_b"])))
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)
    b = s["desc_b"][:200]
    rows = tham.hamming_rows(_t(s["desc_a"]), _t(b)).numpy()
    np.testing.assert_array_equal(rows, np.diag(_popcount_dist(s["desc_a"], b)))
    np.testing.assert_array_equal(
        rows, np.asarray(jham.hamming_rows(_j(s["desc_a"]), _j(b))))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio", [None, 0.8])
def test_match_descriptors_matches_jax(seed, ratio):
    s = _scene(seed)
    dist = _popcount_dist(s["desc_a"], s["desc_b"])
    gate = np.asarray(jsearch.window_gate(_j(s["uv_a"]), _j(s["uv_b"]), 12.0))
    j = jsearch.match_descriptors(_j(dist), _j(gate), 80.0, ratio,
                                  _j(s["valid_a"]), _j(s["valid_b"]))
    t = tsearch.match_descriptors(_t(dist), _t(gate), 80.0, ratio,
                                  _t(s["valid_a"]), _t(s["valid_b"]))
    assert int(t.n) > 50
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    m = t.idx.numpy() >= 0
    np.testing.assert_array_equal(t.dist.numpy()[m], np.asarray(j.dist)[m])


def test_resolve_duplicates_matches_jax():
    rng = np.random.RandomState(3)
    idx = rng.randint(-1, 40, 200).astype(np.int32)
    dist = rng.randint(0, 20, 200).astype(np.int32)   # many ties
    j = jsearch.resolve_duplicates(_j(idx), _j(dist), 40)
    t = tsearch.resolve_duplicates(_t(idx).long(), _t(dist), 40)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_rotation_consistency_matches_jax():
    s = _scene(4)
    rng = np.random.RandomState(4)
    idx = np.where(rng.rand(200) < 0.8, rng.randint(0, 300, 200), -1)
    j = jsearch.rotation_consistency(_j(s["ang_a"]), _j(s["ang_b"]),
                                     _j(idx.astype(np.int32)))
    t = tsearch.rotation_consistency(_t(s["ang_a"]), _t(s["ang_b"]),
                                     _t(idx).long())
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_gates_match_jax():
    s = _scene(5)
    radius = (np.random.RandomState(5).rand(200) * 20).astype(np.float32)
    for r in (10.0, radius):
        j = jsearch.window_gate(_j(s["uv_a"]), _j(s["uv_b"]), _j(r))
        t = tsearch.window_gate(_t(s["uv_a"]), _t(s["uv_b"]),
                                _t(r) if isinstance(r, np.ndarray) else r)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    j = jsearch.octave_gate(_j(s["oct_a"]), _j(s["oct_b"]), -1, 1)
    t = tsearch.octave_gate(_t(s["oct_a"]), _t(s["oct_b"]), -1, 1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [6, 7])
def test_search_for_initialization_matches_jax(seed):
    s = _scene(seed)
    args = [s["uv_a"], s["desc_a"], s["ang_a"], s["oct_a"], s["valid_a"],
            s["uv_b"], s["desc_b"], s["ang_b"], s["oct_b"], s["valid_b"]]
    j = jsearch.search_for_initialization(*[_j(a) for a in args],
                                          window=20.0, max_dist=80.0,
                                          ratio=0.9)
    t = tsearch.search_for_initialization(*[_t(a) for a in args],
                                          window=20.0, max_dist=80.0,
                                          ratio=0.9)
    assert int(t.n) > 50
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))


@pytest.mark.parametrize("seed", [8, 9])
def test_search_by_projection_matches_jax(seed):
    s = _scene(seed)
    radius = (4.0 * 1.2 ** s["oct_a"]).astype(np.float32)
    args = [s["uv_a"], s["oct_a"], s["desc_a"], s["valid_a"], s["uv_b"],
            s["oct_b"], s["desc_b"], s["ang_b"], s["valid_b"], radius]
    j = jsearch.search_by_projection(*[_j(a) for a in args], max_dist=100.0,
                                     ratio=0.8)
    t = tsearch.search_by_projection(*[_t(a) for a in args], max_dist=100.0,
                                     ratio=0.8)
    assert int(t.n) > 30
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
