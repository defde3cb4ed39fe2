"""Tests of the port that need a CUDA card: the hand-written FAST-9+NMS
kernel against its plain PyTorch version, bit-exact, on the card.  They
skip without a card.  This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch import config
from orb_slam2_tpu_torch.frontend import fast_cuda, pyramid

# the 8 pyramid levels of a 640x480 frame, the two shapes of
# tests/test_pallas.py (one not a multiple of the tile) and a tiny level
LEVELS = pyramid.level_shapes(480, 640, 8, 1.2)
SHAPES = LEVELS + [(96, 256), (70, 128), (7, 7)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fast_kernel_matches_plain_on_card(shape):
    _card()
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    img = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).cuda()
    before = fast_cuda.launches
    kn, kr = fast_cuda.fast_nms_raw(img)
    pn, pr = fast_cuda.fast_nms_raw_plain(img)
    torch.cuda.synchronize()
    assert fast_cuda.launches == before + 1
    assert torch.equal(kn, pn) and torch.equal(kr, pr)


@pytest.mark.cuda
def test_extractor_on_card_matches_cpu():
    """One frame through the atlas extractor on the card (8 kernel
    launches) and on the CPU (plain version): the same keypoint slots."""
    _card()
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    from orb_slam2_tpu_torch.io import synthetic
    cfg = config.SLAMConfig()
    img = synthetic.generate(cfg.camera, n_frames=1, n_points=50,
                             seed=0).images[0]
    before = fast_cuda.launches
    g = build_atlas_extractor(cfg.orb, 480, 640, "cuda")(
        torch.from_numpy(img).cuda())
    c = build_atlas_extractor(cfg.orb, 480, 640, "cpu")(torch.from_numpy(img))
    assert fast_cuda.launches == before + cfg.orb.n_levels
    same = ((g.valid.cpu() == c.valid) & (g.octave.cpu() == c.octave) &
            ((g.uv.cpu() - c.uv).abs().amax(-1) <= 1e-3))
    assert float(same.float().mean()) >= 0.99
