"""Parity of the port's frontend/ with the JAX package on the CPU.

* FAST-9 score and 3x3 NMS: min/max of differences of f32 values, so the
  port's plain version must equal both JAX's `fast.py` and the Pallas
  kernel (run in interpret mode, as tests/test_pallas.py runs it) bit for
  bit, borders included; over a level atlas, level by level, zero-padded.
* The cascade resize: JAX's antialiased bilinear `jax.image.resize` against
  the port's two weight matmuls (tolerances in the test).
* The atlas extractor at 240x320: slot layout (uv, octave, valid) equal on
  >= 99% of slots, descriptors within a few bits, because every bit is the
  sign of an f32 product whose sum order differs between XLA and PyTorch.
* The constant tables (BRIEF pattern, moment matrix, patch mask, level
  quotas and shapes, blur taps) exactly.
* The per-level formulation: the single-image FAST entry points against
  the Pallas kernel's, bit for bit; the cell threshold, blur, patch
  gather, BRIEF bits and +-1 rows exactly; the cascade pyramid and the IC
  angle within the float order of their sums; the whole per-level
  extractor at 240x320 with the atlas test's tolerances.
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
from orb_slam2_tpu.frontend.pallas_fast import (fast_nms_pallas,
                                                fast_nms_raw_pallas)
from orb_slam2_tpu.io import synthetic as jsyn
from orb_slam2_tpu_torch import config as tconfig
from orb_slam2_tpu_torch.frontend import atlas as tatlas
from orb_slam2_tpu_torch.frontend import extractor as text
from orb_slam2_tpu_torch.frontend import fast as tfast
from orb_slam2_tpu_torch.frontend import fast_cuda
from orb_slam2_tpu_torch.frontend import orb as torb
from orb_slam2_tpu_torch.frontend import pyramid as tpyr

FAST_SHAPES = [(96, 256), (70, 128)]   # tests/test_pallas.py's shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """A one-level atlas through the port's entry point equals the Pallas
    kernel on that level."""
    img = _img(shape, 1)
    pn, pr = fast_nms_raw_pallas(jnp.asarray(img), interpret=True)
    before = fast_cuda.device_counts()[0]
    tn, tr = fast_cuda.fast_nms_atlas(torch.from_numpy(img)[None], [shape])
    assert fast_cuda.device_counts()[0] == before     # CPU: plain version
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(pn))
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(pr))


ATLAS_LEVELS = tpyr.level_shapes(240, 320, 8, 1.2)


@pytest.fixture(scope="module")
def pallas_level_maps():
    """Two images' worth of 8 levels of 240x320 (seeded values everywhere,
    also outside each level, which no map may read), and per level the
    Pallas kernel's (nms, raw) in interpret mode, zero-padded to the
    atlas plane."""
    H, W = ATLAS_LEVELS[0]
    atlas = (np.random.RandomState(7).rand(16, H, W) * 255).astype(np.float32)
    nms, raw = np.zeros_like(atlas), np.zeros_like(atlas)
    for g in range(16):
        h, w = ATLAS_LEVELS[g % 8]
        n, r = fast_nms_raw_pallas(jnp.asarray(atlas[g, :h, :w]),
                                   interpret=True)
        nms[g, :h, :w], raw[g, :h, :w] = np.asarray(n), np.asarray(r)
    return atlas, nms, raw


@pytest.mark.parametrize("n_images", [1, 2])
def test_fast_atlas_plain_matches_pallas_per_level(pallas_level_maps,
                                                   n_images):
    """`fast_nms_atlas_plain` over an atlas of n_images x 8 levels equals,
    bit for bit, the Pallas kernel run level by level and padded."""
    atlas, jn, jr = pallas_level_maps
    G = 8 * n_images
    before = fast_cuda.device_counts()[0]
    tn, tr = fast_cuda.fast_nms_atlas(torch.from_numpy(atlas[:G]),
                                      ATLAS_LEVELS)
    assert fast_cuda.device_counts()[0] == before
    np.testing.assert_array_equal(tn.numpy(), jn[:G])
    np.testing.assert_array_equal(tr.numpy(), jr[:G])


def test_fast_kernel_wrapper_rejects_bad_input():
    """The CUDA entry refuses, before any launch, what the kernel does not
    take: a tensor off the card, another dtype, another rank, a level
    larger than the plane, planes not a multiple of the levels."""
    before = fast_cuda.device_counts()[0]
    lv = [(32, 32)]
    for bad, shapes in ((torch.zeros((1, 32, 32)), lv),
                        (torch.zeros((1, 32, 32), dtype=torch.float64), lv),
                        (torch.zeros((32, 32)), lv),
                        (torch.zeros((1, 32, 32)), [(33, 32)]),
                        (torch.zeros((3, 32, 32)), lv * 2)):
        with pytest.raises(ValueError):
            fast_cuda.fast_nms_atlas_cuda(bad, shapes)
    for bad, shapes in ((torch.zeros((1, 32, 32)), [(33, 32)]),
                        (torch.zeros((3, 32, 32)), lv * 2)):
        with pytest.raises(ValueError):
            fast_cuda.fast_nms_atlas_plain(bad, shapes)
    assert fast_cuda.device_counts()[0] == before


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


SMALL_ORB = dict(n_features=500, max_keypoints=512)


@pytest.fixture(scope="module")
def image_240x320():
    cam = jconfig.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                               width=320, height=240)
    return jsyn.generate(cam, n_frames=2, n_points=50, seed=0).images[1]


@pytest.fixture(scope="module")
def features_240x320(image_240x320):
    img = image_240x320
    jf = jax.jit(jatlas.build_atlas_extractor(jconfig.ORBConfig(**SMALL_ORB),
                                              240, 320, use_pallas=False))(img)
    tf = tatlas.build_atlas_extractor(tconfig.ORBConfig(**SMALL_ORB), 240,
                                      320, device="cpu")(torch.from_numpy(img))
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


# ---------------------------------------------------------------------------
# the per-level formulation
# ---------------------------------------------------------------------------

def test_single_image_fast_matches_pallas_exactly():
    """`fast_nms` / `fast_nms_raw` on a CPU tensor (the plain version, no
    launch) equal `fast_nms_pallas` / `fast_nms_raw_pallas` in interpret
    mode bit for bit, at test_pallas.py's 96x256."""
    img = _img((96, 256), 5)
    jn, jr = fast_nms_raw_pallas(jnp.asarray(img), interpret=True)
    jn1 = fast_nms_pallas(jnp.asarray(img), interpret=True)
    before = fast_cuda.device_counts()[0]
    tn, tr = fast_cuda.fast_nms_raw(torch.from_numpy(img))
    tn1 = fast_cuda.fast_nms(torch.from_numpy(img))
    assert fast_cuda.device_counts()[0] == before
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tn1.numpy(), np.asarray(jn1))
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_raw(torch.from_numpy(img)[None])


@pytest.fixture(scope="module")
def jax_level_ops():
    """Seeded inputs of the per-level ops and JAX's outputs on them, from
    one jit: a 96x256 NMS score map and its cell threshold; a 120x160
    level, its cascade pyramid and (op by op) its blur; 64 keypoints (four on the
    clamp and rounding edges), their patches of that level, the IC angles
    and the BRIEF bits at given angles, and the bits as +-1 rows."""
    rng = np.random.RandomState(8)
    score = tfast.nms3x3(tfast.fast_score_map(torch.from_numpy(
        _img((96, 256), 6)))).numpy()
    img = _img((120, 160), 7)
    pts = np.stack([rng.uniform(0, 160, 64), rng.uniform(0, 120, 64)],
                   -1).astype(np.float32)
    pts[:4] = [[15.5, 16.5], [0.0, 0.0], [159.0, 119.0], [40.5, 60.5]]
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)

    def ref(score, img, pts, ang):
        patches = jorb.gather_patches(img, pts)
        bits = jorb.brief_descriptors(patches, ang)
        return dict(cell=jfast.cell_threshold(score, 30, 20.0, 7.0),
                    levels=jpyr.build_pyramid(img, 8, 1.2), patches=patches,
                    angle=jorb.ic_angle(patches), bits=bits,
                    pm1=jorb.bits_to_pm1(bits).astype(jnp.float32))

    out = jax.tree_util.tree_map(np.asarray,
                                 jax.jit(ref)(score, img, pts, ang))
    # op by op: under one jit XLA fuses the blur's products and sums, which
    # moves ~40% of its outputs by an ulp or two
    out["blur"] = np.asarray(jpyr.gaussian_blur(jnp.asarray(img), 7, 2.0))
    return dict(score=score, img=img, pts=pts, ang=ang), out


def test_cell_threshold_matches_jax_exactly(jax_level_ops):
    """Per-cell max and two compares: exact (cells of 30 px over a 96x256
    map: the last row and column of cells are partial)."""
    x, j = jax_level_ops
    t = tfast.cell_threshold(torch.from_numpy(x["score"]), 30, 20.0, 7.0)
    assert 0 < (j["cell"] > 0).sum() < (x["score"] > 0).sum()
    np.testing.assert_array_equal(t.numpy(), j["cell"])


def test_pyramid_and_blur_match_jax(jax_level_ops):
    """The cascade pyramid: level shapes equal; each level within 1e-4 of
    the port's weights applied in float64 (its own round-off) and within
    2e-3 of `jax.image.resize` (XLA:CPU's resize product strays ~1e-3 from
    the float64 one on 0-255 pixels, test_resize_matches_jax_image_resize).
    The reflect-padded blur: the same taps summed in the same order, exact."""
    x, j = jax_level_ops
    tl = tpyr.build_pyramid(torch.from_numpy(x["img"]), 8, 1.2)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in j["levels"]]
    for lv, (jl, t) in enumerate(zip(j["levels"], tl)):
        if lv:
            wh, ww = (tpyr.resize_weights(m, n) for m, n in zip(
                tl[lv - 1].shape, t.shape))
            exact = wh.T.astype(np.float64) @ tl[lv - 1].numpy() @ ww
            np.testing.assert_allclose(t.numpy(), exact, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t.numpy(), jl, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(
        tpyr.gaussian_blur(torch.from_numpy(x["img"]), 7, 2.0).numpy(),
        j["blur"])


def test_orb_patches_angle_and_bits_match_jax(jax_level_ops):
    """Patch gather (clamped centres, rounded half to even) and the BRIEF
    bits at given angles exactly; the IC angle within 1e-4 rad (two sums
    of ~700 products in another order); the +-1 rows exactly."""
    x, j = jax_level_ops
    tp = torb.gather_patches(torch.from_numpy(x["img"]),
                             torch.from_numpy(x["pts"]))
    np.testing.assert_array_equal(tp.numpy(), j["patches"])
    np.testing.assert_allclose(torb.ic_angle(tp).numpy(), j["angle"],
                               rtol=0, atol=1e-4)
    tb = torb.brief_descriptors(tp, torch.from_numpy(x["ang"]))
    np.testing.assert_array_equal(tb.numpy(), j["bits"])
    pm1 = torb.bits_to_pm1(tb)
    assert pm1.dtype == torch.bfloat16
    np.testing.assert_array_equal(pm1.to(torch.float32).numpy(), j["pm1"])


def test_perlevel_extractor_matches_jax(image_240x320):
    """The per-level extractor at 240x320 on the atlas test's image against
    JAX's (use_pallas=False), with the atlas test's tolerances: >= 99% of
    slots with the same valid flag, octave and uv within 1e-3 px (the
    cascade's resize differs from XLA's by ~1e-3 of a gray level, which
    can move a corner's score across a neighbour's); responses within 1e-4
    on those slots (the same resize round-off in the FAST differences);
    descriptors: median Hamming 0 and <= 4 bits on >= 98% (each IC angle
    sums ~700 products in another order, which can move a rotated test
    across a pixel boundary)."""
    img = image_240x320
    jf = jax.jit(jext.build_extractor_perlevel(
        jconfig.ORBConfig(**SMALL_ORB), 240, 320, use_pallas=False))(img)
    tf = text.build_extractor_perlevel(tconfig.ORBConfig(**SMALL_ORB), 240,
                                       320, device="cpu")(
        torch.from_numpy(img))
    assert tf.uv.shape == (512, 2) and tf.desc.dtype == torch.uint8
    assert int(np.asarray(jf.valid).sum()) > 300
    same = ((np.asarray(jf.valid) == tf.valid.numpy()) &
            (np.asarray(jf.octave) == tf.octave.numpy()) &
            (np.abs(np.asarray(jf.uv) - tf.uv.numpy()).max(-1) <= 1e-3))
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tf.response.numpy()[same],
                               np.asarray(jf.response)[same], rtol=0,
                               atol=1e-4)
    v = same & tf.valid.numpy()
    ham = (np.unpackbits(np.asarray(jf.desc)[v], axis=1) !=
           np.unpackbits(tf.desc.numpy()[v], axis=1)).sum(1)
    assert np.median(ham) == 0
    assert (ham <= 4).mean() >= 0.98, np.sort(ham)[-10:]
