"""Parity of the port's frontend/ with the JAX package on the CPU.

* FAST-9 score and 3x3 NMS: min/max of differences of f32 values, so the
  port's plain version must equal both JAX's `fast.py` and the Pallas
  kernel (run in interpret mode, as tests/test_pallas.py runs it) bit for
  bit, borders included.
* The cascade resize: JAX's antialiased bilinear `jax.image.resize` against
  the port's two weight matmuls (tolerances in the test).
* The atlas extractor at 240x320: slot layout (uv, octave, valid) equal on
  >= 99% of slots, descriptors within a few bits, because every bit is the
  sign of an f32 product whose sum order differs between XLA and PyTorch.
* The constant tables (BRIEF pattern, moment matrix, patch mask, level
  quotas and shapes, blur taps) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.frontend import atlas as jatlas
from orb_slam2_tpu.frontend import extractor as jext
from orb_slam2_tpu.frontend import fast as jfast
from orb_slam2_tpu.frontend import orb as jorb
from orb_slam2_tpu.frontend import pyramid as jpyr
from orb_slam2_tpu.frontend.pallas_fast import fast_nms_raw_pallas
from orb_slam2_tpu.io import synthetic as jsyn
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch.frontend import atlas as tatlas
from orb_slam2_tpu_torch.frontend import extractor as text
from orb_slam2_tpu_torch.frontend import fast as tfast
from orb_slam2_tpu_torch.frontend import fast_cuda
from orb_slam2_tpu_torch.frontend import orb as torb
from orb_slam2_tpu_torch.frontend import pyramid as tpyr

FAST_SHAPES = [(96, 256), (70, 128)]   # tests/test_pallas.py's shapes


def _img(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.float32)


@pytest.mark.parametrize("shape", FAST_SHAPES)
def test_fast_score_and_nms_match_jax_exactly(shape):
    img = _img(shape, 0)
    jraw = np.asarray(jfast.fast_score_map(jnp.asarray(img)))
    jnms = np.asarray(jfast.nms3x3(jnp.asarray(jraw)))
    traw = tfast.fast_score_map(torch.from_numpy(img))
    tnms = tfast.nms3x3(traw)
    np.testing.assert_array_equal(traw.numpy(), jraw)
    np.testing.assert_array_equal(tnms.numpy(), jnms)


@pytest.mark.parametrize("shape", FAST_SHAPES)
def test_fast_plain_matches_pallas_interpret_exactly(shape):
    img = _img(shape, 1)
    pn, pr = fast_nms_raw_pallas(jnp.asarray(img), interpret=True)
    before = fast_cuda.launches
    tn, tr = fast_cuda.fast_nms_raw(torch.from_numpy(img))
    assert fast_cuda.launches == before      # CPU tensor: plain version
    np.testing.assert_array_equal(tn.numpy(), np.asarray(pn))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(pr))


def test_fast_kernel_wrapper_rejects_bad_input():
    """The CUDA entry refuses, before any launch, what the kernel does not
    take: a tensor off the card, another dtype, another rank."""
    before = fast_cuda.launches
    for bad in (torch.zeros((32, 32)), torch.zeros((32, 32), dtype=torch.float64),
                torch.zeros((2, 32, 32))):
        with pytest.raises(ValueError):
            fast_cuda.fast_nms_cuda(bad)
    assert fast_cuda.launches == before


def test_resize_matches_jax_image_resize():
    """The weight matrices equal JAX's to one f32 ulp (the column sums may
    round differently).  The port's product is
    within 1e-4 of the same product in float64; XLA:CPU's einsum inside
    `jax.image.resize` strays up to ~5.5e-4 from it on 0-255 pixels, so
    port and JAX are held to 1e-3."""
    from jax._src.image import scale as jscale
    cfg = jconfig.ORBConfig()
    shapes = jpyr.level_shapes(240, 320, cfg.n_levels, cfg.scale_factor)
    x = _img(shapes[0], 3)
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        for m, n in ((h0, h1), (w0, w1)):
            jw = jscale.compute_weight_mat(
                m, n, n / m, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR],
                True)
            np.testing.assert_allclose(tpyr.resize_weights(m, n),
                                       np.asarray(jw), rtol=0, atol=1.2e-7)
        j = np.asarray(jax.image.resize(jnp.asarray(x), (h1, w1),
                                        method="bilinear"))
        wh, ww = tpyr.resize_weights(h0, h1), tpyr.resize_weights(w0, w1)
        t = (torch.from_numpy(wh).T @ torch.from_numpy(x) @
             torch.from_numpy(ww)).numpy()
        exact = wh.T.astype(np.float64) @ x.astype(np.float64) @ ww
        np.testing.assert_allclose(t, exact, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)
        x = np.array(j)


def test_constant_tables_match_jax():
    np.testing.assert_array_equal(torb.PATTERN, jorb.PATTERN)
    np.testing.assert_array_equal(torb.circular_mask(), jorb.circular_mask())
    np.testing.assert_array_equal(tatlas._brief_moment_matrix(tatlas.Q_BINS),
                                  jatlas._brief_moment_matrix(jatlas.Q_BINS))
    np.testing.assert_array_equal(tpyr._gauss_kernel1d(7, 2.0),
                                  jpyr._gauss_kernel1d(7, 2.0))
    for h, w, n, s in ((480, 640, 8, 1.2), (240, 320, 8, 1.2)):
        assert tpyr.level_shapes(h, w, n, s) == jpyr.level_shapes(h, w, n, s)
    assert text.per_level_quota(1000, 8, 1.2) == \
        jext.per_level_quota(1000, 8, 1.2)
    np.testing.assert_array_equal(tfast.CIRCLE, jfast.CIRCLE)
    assert tfast.ARC_LEN == jfast.ARC_LEN


def test_pack_unpack_bits_match_jax():
    bits = np.random.RandomState(4).rand(16, 256) > 0.5
    jp = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    tp = torb.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(torb.unpack_bits(tp).numpy(), bits)


@pytest.fixture(scope="module")
def features_240x320():
    cam = jconfig.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                               width=320, height=240)
    img = jsyn.generate(cam, n_frames=2, n_points=50, seed=0).images[1]
    kw = dict(n_features=500, max_keypoints=512)
    jf = jax.jit(jatlas.build_atlas_extractor(jconfig.ORBConfig(**kw), 240,
                                              320, use_pallas=False))(img)
    tf = tatlas.build_atlas_extractor(tconfig.ORBConfig(**kw), 240, 320,
                                      device="cpu")(torch.from_numpy(img))
    return jf, tf


def test_atlas_slots_match_jax(features_240x320):
    jf, tf = features_240x320
    assert int(np.asarray(jf.valid).sum()) > 300
    same = ((np.asarray(jf.valid) == tf.valid.numpy()) &
            (np.asarray(jf.octave) == tf.octave.numpy()) &
            (np.abs(np.asarray(jf.uv) - tf.uv.numpy()).max(-1) <= 1e-3))
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tf.response.numpy()[same],
                               np.asarray(jf.response)[same], rtol=0,
                               atol=1e-4)


def test_atlas_descriptors_match_jax(features_240x320):
    jf, tf = features_240x320
    v = np.asarray(jf.valid) & tf.valid.numpy()
    ham = (np.unpackbits(np.asarray(jf.desc)[v], axis=1) !=
           np.unpackbits(tf.desc.numpy()[v], axis=1)).sum(1)
    assert np.median(ham) == 0
    assert (ham <= 4).mean() >= 0.98, np.sort(ham)[-10:]
    np.testing.assert_allclose(tf.angle.numpy()[v], np.asarray(jf.angle)[v],
                               rtol=0, atol=1e-3)
