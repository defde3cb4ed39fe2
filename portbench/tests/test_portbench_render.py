"""The card renderer against the frozen numpy generator, on the CPU."""

import numpy as np
import pytest
import torch

from portbench import reference, render, scene

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


# a ring road round a 16 m block at the drive's 0.08 m a frame, and the
# rehearsal's tiny one
LOOPS = [dict(speed=0.08, block=16.0, ring=6.0, corner=3.0, overrun=160),
         dict(speed=0.1, block=1.0, ring=4.0, corner=2.5, overrun=20)]


@pytest.mark.parametrize("motion", LOOPS, ids=["block", "tiny"])
def test_loop_route_closes_and_keeps_off_the_walls(motion):
    """One lap after frame 0 the pose is frame 0's; both eyes of a KITTI
    rig stay 1 m or more from every plane of the room."""
    lap, n = render.loop_lap(**motion)
    twc = render.loop_trajectory(n + motion["overrun"], **motion)
    assert np.abs(twc[n] - twc[0]).max() < 1e-9
    steps = np.linalg.norm(np.diff(twc[:, 4:], axis=0), axis=1)
    assert np.allclose(steps, lap / n, rtol=1e-3)
    room = render.loop_room(CAM, motion["block"], motion["ring"])
    for eye in (twc, scene.right_poses(twc, 386.1448 / 718.856)):
        d = reference.plane_distances(eye[:, 4:], room.planes, room.extents)
        assert d.min() >= 1.0
    with pytest.raises(ValueError):
        render.loop_trajectory(n, **motion)


def test_every_pixel_of_a_lap_hits_a_plane():
    m = LOOPS[0]
    lap, n = render.loop_lap(**m)
    room = render.loop_room(CAM, m["block"], m["ring"])
    tex = render.make_textures(np.random.RandomState(3), room, "cpu")
    twc = render.loop_trajectory(n + m["overrun"], **m)[::37]
    _, depth = render.cast(room, tex, render.pixel_rays(CAM, "cpu"), twc)
    assert (depth > 0).all()


def test_block_wall_depth_matches_the_analytic_distance():
    """The centre row of two views past a corner of the block: the block's
    wall where the ray meets it within its edges, and beyond its edge the
    outer wall behind it."""
    m = LOOPS[0]
    room = render.loop_room(CAM, m["block"], m["ring"])
    tex = render.make_textures(np.random.RandomState(3), room, "cpu")
    yaw = -np.pi / 2        # facing -x: the camera's x axis is world +z
    twc = np.array([[1.0, 0, 0, 0, 11.0, 0, 0],
                    [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0, 11.0, 0, 7.0]])
    _, depth = render.cast(room, tex, render.pixel_rays(CAM, "cpu"), twc)
    xn = (np.arange(CAM.width) - CAM.cx) / CAM.fx
    row = depth[:, int(CAM.cy)].numpy()
    # heading +z from (11, 0, 0): on the left the block's x = 8 wall for
    # x_n <= -3/8 (it ends at z = 8), on the right the outer wall x = 14,
    # else the outer wall z = 14 ahead
    with np.errstate(divide="ignore"):
        side = 3 / np.abs(xn)
    want = np.where(xn <= -3 / 8, side,
                    np.where(xn > 0, np.minimum(side, 14.0), 14.0))
    assert np.allclose(row[0], want, rtol=1e-5)
    # heading -x from (11, 0, 7): the wall at depth 3 up to its edge z = 8
    # (x_n = 1/3), past it the outer wall z = 14 (depth 7 / x_n)
    want = np.where(xn <= 1 / 3, 3.0, 7 / np.maximum(xn, 1 / 3))
    assert np.allclose(row[1], want, rtol=1e-5)
    assert (row[1][xn <= 1 / 3] == np.float32(3.0)).all()


def test_existing_rooms_keep_infinite_planes():
    """The rooms of the xyz and drive cells have no extents, and a plane
    without one renders as before (the same operations, bit for bit)."""
    for corridor in (False, True):
        room = render.make_room(CAM, 40, corridor=corridor)
        assert room.extents is None and len(room.planes) == 5
        tex = render.make_textures(np.random.RandomState(5), room, "cpu")
        rays = render.pixel_rays(CAM, "cpu")
        twc = render.drive_trajectory(3) if corridor else \
            render.xyz_trajectory(3)
        a = render.cast(room, tex, rays, twc)
        room.extents = [None] * 5
        b = render.cast(room, tex, rays, twc)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
