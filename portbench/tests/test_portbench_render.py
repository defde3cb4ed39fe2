"""The card renderer against the frozen numpy generator, on the CPU."""

import numpy as np
import pytest
import torch

from portbench import render, scene

CAM = render.Camera(fx=200.0, fy=200.0, cx=80.0, cy=60.0, width=160,
                    height=120, fps=30.0)


@pytest.mark.parametrize("trajectory", ["xyz", "forward"])
def test_render_matches_numpy_generator(trajectory):
    seq = scene.generate(CAM, n_frames=3, n_points=10, trajectory=trajectory,
                         seed=5, noise_sigma=0)
    room = render.make_room(CAM, 3, corridor=trajectory == "forward")
    tex = render.make_textures(np.random.RandomState(5), room, "cpu")
    img, depth = render.cast(room, tex, render.pixel_rays(CAM, "cpu"),
                             seq.poses_twc)
    assert np.abs(img.numpy() - seq.images).max() < 1e-3
    assert np.abs(depth.numpy() - seq.depths).max() < 1e-5


def test_xyz_phase_zero_is_the_generators_trajectory():
    assert np.allclose(render.xyz_trajectory(50), scene.xyz_trajectory(50))


def test_lens_round_trip():
    cam = render.Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                        height=480, fps=30.0, k1=0.262383, k2=-0.953104,
                        p1=-0.005358, p2=0.002628, k3=1.163314)
    u, v = np.meshgrid(np.arange(0, 640, 37.0), np.arange(0, 480, 29.0))
    x, y = render.undistort_normalised(cam, u, v)
    u2, v2 = render.distort_pixels(cam, x, y)
    assert np.abs(u2 - u).max() < 1e-6 and np.abs(v2 - v).max() < 1e-6


def test_sequence_is_a_function_of_the_seed():
    big = 2 ** 31 + 977
    a = render.render_sequence(CAM, "xyz", 4, big, stereo=True,
                               with_depth=True, device="cpu")
    b = render.render_sequence(CAM, "xyz", 4, big, stereo=True,
                               with_depth=True, device="cpu")
    c = render.render_sequence(CAM, "xyz", 4, big + 1, stereo=True,
                               with_depth=True, device="cpu")
    assert torch.equal(a.images, b.images) and torch.equal(a.right, b.right)
    assert torch.equal(a.depth, b.depth)
    assert not torch.equal(a.images, c.images)
    # fixed textures: the seed draws the noise alone
    d, e = (render.render_sequence(CAM, "xyz", 4, sd, stereo=False,
                                   with_depth=False, device="cpu",
                                   noise_sigma=0, texture_seed=7)
            for sd in (big, big + 1))
    assert torch.equal(d.images, e.images)
    f = render.render_sequence(CAM, "xyz", 4, big, stereo=False,
                               with_depth=False, device="cpu",
                               texture_seed=7)
    assert not torch.equal(d.images, f.images)
    assert a.images.dtype == torch.uint8
    # depth as the TUM reader gives it: 16-bit at the factor, in metres
    raw = a.depth.double() * CAM.depth_map_factor
    assert torch.allclose(raw, torch.round(raw), atol=1e-2)
