"""The port's ROS node adapters (io/ros.py) against the JAX package's, on
the CPU.  No ROS is installed: the conversion cores are compared exactly
(mirroring tests/test_ros_core.py), and the three nodes of both packages
are built on fake `rospy`, `cv_bridge`, `sensor_msgs.msg` and
`message_filters` modules and driven through their callbacks into a stub
session that records its calls.  The port must hand the session the same
arrays and stamps; its stereo rectification (numpy bilinear remap) is held
to tests/test_torch_io.py's remap tolerance against the JAX node's
cv2.remap."""

import sys
import types

import numpy as np
import pytest

from orb_slam2_tpu.io import ros as jros
from orb_slam2_tpu_torch.io import ros as tros


def test_to_gray_matches_jax_exactly():
    rng = np.random.RandomState(0)
    mono = rng.randint(0, 256, (3, 4)).astype(np.uint8)
    rgb = rng.randint(0, 256, (5, 6, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (5, 6, 4)).astype(np.uint8)
    for img in (mono, rgb, rgba):
        for order in (True, False):
            j, t = jros._to_gray(img, rgb=order), tros._to_gray(img, rgb=order)
            assert t.dtype == j.dtype == np.float32
            np.testing.assert_array_equal(t, j)
    # R weighs 0.299 in RGB order, 0.114 in BGR order (Tracking.cc:172-197)
    red = np.zeros((2, 2, 3), np.uint8)
    red[..., 0] = 100
    assert abs(tros._to_gray(red, rgb=True)[0, 0] - 29.9) < 0.5
    assert abs(tros._to_gray(red, rgb=False)[0, 0] - 11.4) < 0.5


def test_to_depth_matches_jax_exactly():
    d16 = np.random.RandomState(1).randint(0, 65535, (4, 5)).astype(np.uint16)
    for d in (d16, d16.astype(np.float32) / 5000.0,
              d16.astype(np.float64) / 5000.0):
        j, t = jros._to_depth(d, 5000.0), tros._to_depth(d, 5000.0)
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(
        tros._to_depth(np.full((2, 2), 5000, np.uint16), 5000.0), 1.0)


class _Stamp:
    def __init__(self, t):
        self.t = t

    def to_sec(self):
        return self.t


class _Msg:
    """An Image message: the payload cv_bridge returns and a header."""

    def __init__(self, payload, t):
        self.payload = payload
        self.header = types.SimpleNamespace(stamp=_Stamp(t))


@pytest.fixture
def fake_ros(monkeypatch):
    """Fake ROS modules in sys.modules; returns the registered callbacks
    (topic subscriptions and synchronizer callbacks) in order."""
    reg = {"subs": [], "sync": []}
    rospy = types.ModuleType("rospy")
    rospy.Subscriber = lambda topic, typ, cb, queue_size=None: \
        reg["subs"].append((topic, cb))
    rospy.spin = lambda: None
    rospy.init_node = lambda name: None
    cv_bridge = types.ModuleType("cv_bridge")
    cv_bridge.CvBridge = lambda: types.SimpleNamespace(
        imgmsg_to_cv2=lambda msg: msg.payload)
    sensor_msgs = types.ModuleType("sensor_msgs")
    msg_mod = types.ModuleType("sensor_msgs.msg")
    msg_mod.Image = object
    sensor_msgs.msg = msg_mod
    mf = types.ModuleType("message_filters")
    mf.Subscriber = lambda topic, typ: topic

    class Sync:
        def __init__(self, subs, queue, slop):
            self.subs = subs

        def registerCallback(self, cb):
            reg["sync"].append((tuple(self.subs), cb))

    mf.ApproximateTimeSynchronizer = Sync
    for name, mod in (("rospy", rospy), ("cv_bridge", cv_bridge),
                      ("sensor_msgs", sensor_msgs),
                      ("sensor_msgs.msg", msg_mod),
                      ("message_filters", mf)):
        monkeypatch.setitem(sys.modules, name, mod)
    return reg


class _Session:
    """Records every track_* call (method, arrays, stamp)."""

    def __init__(self):
        self.cfg = types.SimpleNamespace(
            camera=types.SimpleNamespace(depth_map_factor=5000.0))
        self.calls = []
        self.flushed = 0

    def __getattr__(self, name):
        if not name.startswith("track_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name,) + a)

    def flush(self):
        self.flushed += 1


def _rgb(seed, shape=(48, 64)):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,)
                                               ).astype(np.uint8)


def _rectify_maps(shape=(48, 64)):
    """Smooth float32 maps, a sub-pixel warp that leaves the image at one
    corner (taps outside read 0)."""
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    m1x = xx + 0.37 + 0.02 * yy
    m1y = yy - 0.61 + 0.01 * xx
    m2x = xx * 1.01 - 0.25
    m2y = yy + 0.5
    return tuple(a.astype(np.float32) for a in (m1x, m1y, m2x, m2y))


def _drive(pkg, fake_ros, rectify):
    """Build the three nodes of `pkg` and drive each callback once;
    returns the recorded session calls and the subscribed topics."""
    calls, topics = [], []
    for make, args in (
            (pkg.MonoNode, lambda: (_Msg(_rgb(0), 1.5),)),
            (lambda s: pkg.StereoNode(s, rectify=rectify),
             lambda: (_Msg(_rgb(1), 2.25), _Msg(_rgb(2), 2.3))),
            (pkg.RGBDNode, lambda: (_Msg(_rgb(3), 3.0), _Msg(
                np.random.RandomState(4).randint(0, 20000, (48, 64)
                                                 ).astype(np.uint16), 3.01)))):
        s = _Session()
        fake_ros["subs"].clear()
        fake_ros["sync"].clear()
        node = make(s)
        regs = fake_ros["subs"] + fake_ros["sync"]
        assert len(regs) == 1
        topics.append(regs[0][0])
        regs[0][1](*args())
        node.spin()
        assert s.flushed == 1
        calls += s.calls
    return calls, topics


@pytest.mark.parametrize("rectify", [False, True])
def test_nodes_pass_the_same_frames_as_jax(fake_ros, rectify):
    """Mono and RGB-D nodes, and the stereo node without rectification:
    the same method, arrays (exactly) and stamps as the JAX nodes.  With
    rectification, the stereo pair within 1e-4 of the JAX node's cv2.remap
    (exact bilinear weights both; float32 rounding, as
    test_remap_matches_cv2 in tests/test_torch_io.py)."""
    maps = _rectify_maps() if rectify else None
    jcalls, jtopics = _drive(jros, fake_ros, maps)
    tcalls, ttopics = _drive(tros, fake_ros, maps)
    assert ttopics == jtopics
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == \
        ["track_mono", "track_stereo", "track_rgbd"]
    for t, j in zip(tcalls, jcalls):
        assert t[-1] == j[-1]                        # the stamp
        for a, b in zip(t[1:-1], j[1:-1]):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            if rectify and t[0] == "track_stereo":
                assert np.abs(a - b).max() <= 1e-4
            else:
                np.testing.assert_array_equal(a, b)
        if rectify and t[0] == "track_stereo":
            # the left map leaves the image at the bottom-right corner
            assert t[1][-1, -1] == 0 and j[1][-1, -1] == 0


def test_main_builds_the_node_for_the_sensor(fake_ros, monkeypatch):
    """`main(["mono", settings])` makes a session from the settings on the
    named device, spins a MonoNode and writes the keyframe trajectory."""
    made = {}

    class FakeSLAM(_Session):
        def __init__(self, cfg, device=None):
            super().__init__()
            made.update(cfg=cfg, device=device, slam=self)

        def save_keyframe_trajectory_tum(self, path):
            made["saved"] = path

    monkeypatch.setattr("orb_slam2_tpu_torch.pipeline.system.SLAM",
                        FakeSLAM)
    monkeypatch.setattr("orb_slam2_tpu_torch.io.settings.load_settings",
                        lambda path, sensor: ("cfg", path, sensor))
    tros.main(["mono", "cam.yaml", "--device", "cpu"])
    assert made["cfg"] == ("cfg", "cam.yaml", 0)
    assert made["device"] == "cpu"
    assert made["saved"] == "KeyFrameTrajectory.txt"
    assert made["slam"].flushed == 1
    assert fake_ros["subs"][0][0] == "/camera/image_raw"
