"""The port's headless renderers (viz/viewer.py, viz/ar.py, raster.py)
against the JAX package's matplotlib ones, on the CPU.

The JAX renderers' drawing calls are recorded by wrapping matplotlib's
`Axes.scatter/plot/text` (and the 3-D `Axes3D` ones) with monkeypatch and
turned into the port's primitives; the port's `*_scene` functions must
return the same primitives: coordinates equal in float64 (both compute
the same numpy float32 arithmetic), the same colours, marker areas, line
widths, alphas, labels and text.  `_camera_centers`, `_axes_of` and
`detect_plane` must equal JAX's exactly, `cube_vertices` within 1e-12.
The port's PNGs are read back with `io/png.read_png` and checked pixel by
pixel where the primitives say a colour must be.
"""

import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from matplotlib.axes import Axes  # noqa: E402
from mpl_toolkits.mplot3d.axes3d import Axes3D  # noqa: E402

from orb_slam2_tpu import cli as jcli  # noqa: E402
from orb_slam2_tpu import config as jconfig  # noqa: E402
from orb_slam2_tpu.map import checkpoint as jcheckpoint  # noqa: E402
from orb_slam2_tpu.map.state import MapState as JMapState  # noqa: E402
from orb_slam2_tpu.map.state import empty_map  # noqa: E402
from orb_slam2_tpu.viz import ar as jar  # noqa: E402
from orb_slam2_tpu.viz import viewer as jviewer  # noqa: E402
from orb_slam2_tpu_torch import cli as tcli  # noqa: E402
from orb_slam2_tpu_torch import convert  # noqa: E402
from orb_slam2_tpu_torch.io.png import read_png  # noqa: E402
from orb_slam2_tpu_torch.viz import ar as tar  # noqa: E402
from orb_slam2_tpu_torch.viz import raster  # noqa: E402
from orb_slam2_tpu_torch.viz import viewer as tviewer  # noqa: E402
from test_ar import _cloud_on_plane  # noqa: E402

LIME = (0, 255, 0)


@pytest.fixture
def recorded(monkeypatch):
    """matplotlib's drawing calls, as port primitives, in call order.  A 3-D
    call is recorded once (Axes3D.scatter/plot call the 2-D ones)."""
    out = []

    def wrap(cls, name):
        orig = getattr(cls, name)

        def f(self, *a, **k):
            if isinstance(self, Axes3D) == (cls is Axes3D):
                out.append(_primitive(name, a, k))
            return orig(self, *a, **k)

        monkeypatch.setattr(cls, name, f)

    for cls in (Axes, Axes3D):
        for name in ("scatter", "plot", "text"):
            wrap(cls, name)
    return out


def _primitive(name, a, k):
    if name == "text":
        box = k.get("bbox") or {}
        return raster.Text((float(a[0]), float(a[1])), a[2], k["color"],
                           float(k["fontsize"]), box.get("facecolor"),
                           box.get("alpha", 1.0))
    pts = np.stack([np.asarray(v, np.float64) for v in a], -1)
    if name == "plot":
        return raster.Line(pts, k["c"], k["lw"], k.get("alpha", 1.0),
                           k.get("ls", "-"), k.get("label"))
    filled = k.get("facecolors") != "none"
    return raster.Marks(pts, k.get("c", k.get("edgecolors")),
                        k.get("marker", "o"), k["s"], filled,
                        0.0 if filled else k["linewidths"],
                        k.get("alpha", 1.0), k.get("label"))


def _same(port, jax_calls):
    """The port's primitives (marks, lines, texts in call order) equal the
    recorded JAX calls."""
    assert len(port) == len(jax_calls), (len(port), len(jax_calls))
    for p, j in zip(port, jax_calls):
        assert type(p) is type(j), (p, j)
        for f, a, b in zip(p._fields, p, j):
            if isinstance(a, np.ndarray):
                assert a.dtype == np.float64 and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, (f, a, b)


def _frame_inputs():
    """tests/test_viewer.py's frame."""
    rng = np.random.RandomState(0)
    img = rng.rand(120, 160) * 255
    uv = rng.rand(64, 2) * [160, 120]
    valid = rng.rand(64) > 0.3
    pids = np.where(rng.rand(64) > 0.5, np.arange(64), -1)
    vo = rng.rand(64) > 0.6
    return img, uv, valid, pids, vo


@pytest.mark.parametrize("status,loc_only,with_vo",
                         [(0, False, False), (1, False, False),
                          (2, False, False), (3, False, False),
                          (2, True, True)])
def test_frame_scene_matches_jax_render_frame(recorded, tmp_path, status,
                                              loc_only, with_vo):
    img, uv, valid, pids, vo = _frame_inputs()
    vo = vo if with_vo else None
    jviewer.render_frame(img, uv, valid, pids, status, 5, 321,
                         str(tmp_path / "j.png"), vo_flags=vo,
                         loc_only=loc_only)
    sc = tviewer.frame_scene(img, uv, valid, pids, status, 5, 321,
                             vo_flags=vo, loc_only=loc_only)
    _same(list(sc.marks) + list(sc.texts), recorded)
    assert sc.size == (160, 146) and sc.axes == "image"
    if status == 2:
        s = sc.texts[0].text
        assert s.startswith("LOCALIZATION | " if loc_only else "SLAM MODE | ")
        assert ("+ VO matches" in s) == with_vo


def test_frame_without_keypoints_matches_jax(recorded, tmp_path):
    """test_viewer.py's empty frames: only the status text."""
    img, uv = np.zeros((60, 80)), np.zeros((4, 2))
    for status in (0, 1, 3):
        recorded.clear()
        jviewer.render_frame(img, uv, np.zeros(4, bool), np.full(4, -1),
                             status, 0, 0, str(tmp_path / "j.png"))
        sc = tviewer.frame_scene(img, uv, np.zeros(4, bool), np.full(4, -1),
                                 status, 0, 0)
        _same(list(sc.marks) + list(sc.texts), recorded)


def test_render_frame_png_pixels(tmp_path):
    """The w x (h + 26) PNG: the image's gray levels where nothing is
    drawn, the tracked colour on every tracked keypoint's square outline,
    and black status text on a white band."""
    img, uv, valid, pids, _ = _frame_inputs()
    out = tviewer.render_frame(img, uv, valid, pids, 2, 5, 321,
                               str(tmp_path / "f.png"))
    px = read_png(out)
    assert px.shape == (146, 160, 3) and px.dtype == np.uint8
    tracked = valid & (pids >= 0)
    assert tracked.sum() > 10
    for x, y in np.floor(uv[tracked]).astype(int):
        r = y - 3 if y >= 3 else y + 3          # the square's top/bottom edge
        assert tuple(px[r, x]) == LIME, (x, y)
    band = px[120:]
    assert (band == 0).all(-1).any() and (band == 255).all(-1).any()
    assert not (band[:8] == 0).all(-1).any()     # text sits lower in the band
    drawn = np.zeros((146, 160), bool)
    for x, y in np.floor(uv[valid]).astype(int):
        drawn[max(y - 4, 0):y + 5, max(x - 4, 0):x + 5] = True
    g = np.clip(np.floor(img / 255.0 * 256.0), 0, 255).astype(np.uint8)
    free = ~drawn[:120]
    np.testing.assert_array_equal(px[:120][free][:, 0], g[free])


def test_trajectory_scene_matches_jax(recorded, tmp_path):
    t = np.linspace(0, 2 * np.pi, 50)
    twc = np.zeros((50, 7))
    twc[:, 0] = 1
    twc[:, 4] = np.cos(t)
    twc[:, 6] = np.sin(t)
    gt = twc.copy()
    gt[:, 4] *= 1.1
    jviewer.render_trajectory(twc, str(tmp_path / "j.png"), gt_twc=gt)
    sc = tviewer.trajectory_scene(twc, gt)
    _same(list(sc.lines), recorded)
    px = read_png(tviewer.render_trajectory(twc, str(tmp_path / "t.png"),
                                            gt_twc=gt))
    assert px.shape == (1040, 1040, 3)
    assert (px == (0x1f, 0x77, 0xb4)).all(-1).sum() > 500   # tab:blue


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def small_map():
    """A hand-built map: 6 valid of 8 keyframes on a ring, covisibility
    weights around min_covis, parents (one invalid, one to an invalid
    keyframe), two loop edges (one stored both ways), 64 point slots; as
    numpy fields, the JAX MapState of them and the port's."""
    rng = np.random.RandomState(3)
    cap = jconfig.Capacity(max_keyframes=8, max_points=64, max_obs_per_kf=16,
                           max_frames=16)
    st = empty_map(jconfig.SLAMConfig(cap=cap))
    f = {k: np.array(v) for k, v in zip(st._fields, st)}
    K = 8
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    f["kf_pose"] = np.concatenate(
        [_unit_quats(rng, K), np.stack([np.cos(ang), 0.1 * rng.randn(K),
                                        np.sin(ang)], -1)], 1
    ).astype(np.float32)
    f["kf_valid"] = np.array([1, 1, 1, 0, 1, 1, 1, 0], bool)
    w = rng.randint(0, 30, (K, K))
    f["covis"] = np.triu(w, 1) + np.triu(w, 1).T
    f["kf_parent"] = np.array([-1, 0, 1, 2, 3, 4, 5, 6], np.int32)
    le = np.zeros((K, K), bool)
    le[1, 5] = le[5, 1] = le[0, 6] = True
    f["loop_edge"] = le
    f["mp_pos"] = (rng.randn(64, 3) * [2, 0.5, 2]).astype(np.float32)
    f["mp_valid"] = rng.rand(64) > 0.3
    traj = np.concatenate([_unit_quats(rng, 20), rng.randn(20, 3)], 1)
    return f, JMapState(**f), convert.map_state_from_numpy(f, "cpu"), traj


def test_camera_centers_and_axes_match_jax_exactly(small_map):
    f, _, _, _ = small_map
    np.testing.assert_array_equal(tviewer._camera_centers(f["kf_pose"]),
                                  jviewer._camera_centers(f["kf_pose"]))
    np.testing.assert_array_equal(tviewer._axes_of(f["kf_pose"], 0.07),
                                  jviewer._axes_of(f["kf_pose"], 0.07))


def test_map_scene_matches_jax_render_map(recorded, small_map, tmp_path):
    """Map points, keyframes, their glyphs, covisibility edges >= 15 (each
    pair once), the spanning tree to valid parents, loop edges and the
    trajectory, as JAX draws them (x, z, -y)."""
    f, jstate, tstate, traj = small_map
    jviewer.render_map(jstate, str(tmp_path / "j.png"), traj=traj)
    sc = tviewer.map_scene(tstate, traj)
    _same(list(sc.marks) + list(sc.lines), recorded)
    kinds = [ln.color for ln in sc.lines]
    assert kinds.count("tab:red") == 2 and kinds.count("0.3") == 4
    assert 0 < kinds.count("tab:green") < 15
    assert sc.view == (-65.0, -90.0) and sc.labels == ("x", "z", "-y")
    px = read_png(tviewer.render_map(tstate, str(tmp_path / "m.png"),
                                     traj=traj, title="map"))
    assert px.shape == (1170, 1430, 3)
    for rgb in ((0x1f, 0x77, 0xb4), (0xd6, 0x27, 0x28), (0xff, 0x7f, 0x0e)):
        assert (px == rgb).all(-1).sum() > 20, rgb


def test_view_command_on_a_jax_checkpoint(recorded, small_map, tmp_path,
                                          monkeypatch):
    """`view --map --traj` on a map JAX's save_map wrote and a TUM file:
    the port renders the scene JAX's `view` draws and writes the PNG;
    `view --traj` alone renders the trajectory."""
    f, jstate, _, traj = small_map
    path = str(tmp_path / "map.npz")
    jcheckpoint.save_map(jstate, path)
    tum = str(tmp_path / "traj.txt")
    rows = np.concatenate([np.arange(len(traj))[:, None] * 0.1,
                           traj[:, 4:7], traj[:, [1, 2, 3, 0]]], 1)
    np.savetxt(tum, rows)
    jcli.main(["view", "--map", path, "--traj", tum, "--out",
               str(tmp_path / "j.png")])
    scenes = []
    orig = tviewer.map_scene
    monkeypatch.setattr(tviewer, "map_scene",
                        lambda *a, **k: scenes.append(orig(*a, **k)) or
                        scenes[-1])
    out = tcli.main(["view", "--map", path, "--traj", tum, "--out",
                     str(tmp_path / "t.png")])
    assert out == str(tmp_path / "t.png") and os.path.exists(out)
    sc = scenes[0]
    assert sc.title == "map.npz"
    _same(list(sc.marks) + list(sc.lines), recorded)
    assert read_png(out).shape == (1170, 1430, 3)
    out2 = tcli.main(["view", "--traj", tum, "--out",
                      str(tmp_path / "t2.png")])
    assert read_png(out2).shape == (1040, 1040, 3)


def test_detect_plane_and_cube_match_jax():
    """RANSAC with RandomState(seed) and the SVD refit: the same plane
    exactly; too few or too weakly observed points: None in both."""
    pts, n_gt = _cloud_on_plane()
    M = len(pts)
    for seed in (0, 1):
        jp = jar.detect_plane(pts, np.ones(M, bool), np.full(M, 10),
                              seed=seed)
        tp = tar.detect_plane(pts, np.ones(M, bool), np.full(M, 10),
                              seed=seed)
        for a, b in ((tp.n, jp.n), (tp.o, jp.o), (tp.Rwp, jp.Rwp)):
            np.testing.assert_array_equal(a, b)
        assert abs(tp.n @ n_gt) > 0.99
        np.testing.assert_allclose(tar.cube_vertices(tp, 0.1),
                                   jar.cube_vertices(jp, 0.1), rtol=0,
                                   atol=1e-12)
    few, _ = _cloud_on_plane(n=20, outliers=0)
    assert tar.detect_plane(few, np.ones(20, bool), np.full(20, 10)) is None
    assert tar.detect_plane(pts, np.ones(M, bool), np.full(M, 2)) is None


def test_ar_scene_matches_jax_render_ar(recorded, tmp_path):
    """test_ar.py's cloud, plane and pose (the cube projects outside the
    frame), and a pose looking at the plane's origin from 0.5 m (the cube
    in view): the 12 edges and the status text as JAX draws them; the
    PNG has the cube's colour at the in-frame edge midpoints."""
    pts, _ = _cloud_on_plane()
    plane = tar.detect_plane(pts, np.ones(len(pts), bool),
                             np.full(len(pts), 10), seed=1)
    img = np.full((120, 160), 128, np.float32)
    K4 = np.array([100.0, 100.0, 80.0, 60.0])
    near = np.concatenate([[1.0, 0, 0, 0], -plane.o + [0, 0, 0.5]])
    for Tcw in (np.array([1.0, 0, 0, 0, 0, 0, 0]), near):
        recorded.clear()
        jar.render_ar(img, Tcw, K4, plane, str(tmp_path / "j.png"),
                      status="SLAM")
        sc = tar.ar_scene(img, Tcw, K4, plane, status="SLAM")
        assert len(sc.lines) == 12
        _same(list(sc.lines) + list(sc.texts), recorded)
    px = read_png(tar.render_ar(img, near, K4, plane,
                                str(tmp_path / "ar.png"), status="SLAM"))
    assert px.shape == (120, 160, 3)
    mids = [np.floor(ln.pts.mean(0)).astype(int) for ln in sc.lines]
    inside = [(x, y) for x, y in mids if 0 <= x < 160 and 0 <= y < 100]
    assert len(inside) >= 6
    for x, y in inside:
        assert tuple(px[y, x]) == LIME, (x, y)
    assert (px == 128).all(-1).any()
    # no plane: the frame and the text only
    assert not tar.ar_scene(img, near, K4, None).lines


def test_font_covers_printable_ascii():
    """95 glyphs of 5x7; every printable character but space has ink."""
    assert raster._FONT.shape == (95, 7, 5)
    ink = raster._FONT.reshape(95, -1).any(1)
    assert not ink[0] and ink[1:].all()
    assert raster.glyphs("ab").shape == (7, 12)


@pytest.mark.parametrize("elev,azim", [(-65.0, -90.0), (30.0, -60.0),
                                       (10.0, 20.0), (-20.0, 135.0)])
def test_view_basis_follows_matplotlib(elev, azim):
    """The screen right/up vectors of (elev, azim) are matplotlib's: each
    unit axis of a cube seen through an orthographic `view_init(elev,
    azim)` 3-D axes moves the projection the same way (up to scale)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import proj3d
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_proj_type("ortho")
    ax.set_box_aspect((1, 1, 1))
    for lim in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        lim(-1, 1)
    ax.view_init(elev=elev, azim=azim)
    M = ax.get_proj()
    o = np.array(proj3d.proj_transform(0, 0, 0, M)[:2])
    mpl = np.array([np.array(proj3d.proj_transform(*e, M)[:2]) - o
                    for e in np.eye(3)])
    plt.close(fig)
    u, v = raster.view_basis(elev, azim)
    mine = np.stack([u, v], 1)                 # axis e -> (e.u, e.v)
    scale = np.linalg.norm(mpl) / np.linalg.norm(mine)
    np.testing.assert_allclose(mine * scale, mpl, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_write_png_round_trips(tmp_path, kind):
    """`write_png` of 8-bit gray, 8-bit RGB and 16-bit gray arrays: read
    back exactly by `read_png` and by OpenCV (a standard PNG); other
    arrays raise."""
    import cv2
    from orb_slam2_tpu_torch.io.png import write_png
    rng = np.random.RandomState(2)
    arr = {"gray8": rng.randint(0, 256, (7, 9)).astype(np.uint8),
           "rgb8": rng.randint(0, 256, (7, 9, 3)).astype(np.uint8),
           "gray16": rng.randint(0, 65536, (7, 9)).astype(np.uint16)}[kind]
    path = write_png(str(tmp_path / "a.png"), arr)
    np.testing.assert_array_equal(read_png(path), arr)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(cv[..., ::-1] if arr.ndim == 3 else cv,
                                  arr)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), arr.astype(np.float32))
