"""The port's input/output layer against the JAX package and OpenCV, on the
CPU: settings YAML, PNG reading, EuRoC rectification, the dataset
loaders, the ORBvoc text format and vocabulary training, and the
command-line entry point on small TUM-mono (a pinhole and the fr1 lens),
KITTI and EuRoC directories.

The port reads images without OpenCV; this machine has OpenCV, so every
reader is held against it on files OpenCV writes (and, for the PNG
filters OpenCV does not emit, on files written here).  Tolerances and
their reasons stand in each test.
"""

import dataclasses
import importlib.util
import os
import struct
import time
import zlib

import cv2
import numpy as np
import pytest
import torch

from orb_slam2_tpu import cli as jcli
from orb_slam2_tpu import config as jconfig
from orb_slam2_tpu.io import datasets as jdatasets
from orb_slam2_tpu.io import evaluate, synthetic
from orb_slam2_tpu.io.settings import load_settings as jload_settings
from orb_slam2_tpu.place import vocab as jvocab
from orb_slam2_tpu_torch import cli as tcli
from orb_slam2_tpu_torch import native_build
from orb_slam2_tpu_torch.io import datasets as tdatasets
from orb_slam2_tpu_torch.io import png
from orb_slam2_tpu_torch.io.settings import load_settings as tload_settings
from orb_slam2_tpu_torch.core import camera as tcamera
from orb_slam2_tpu_torch.io.settings import read_opencv_yaml
from orb_slam2_tpu_torch.place import vocab as tvocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_io_ingest.py's camera and YAML keys
CAM = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240,
           fps=30.0)
SETTINGS = """%YAML:1.0

# a comment line
Camera.fx: 200.0
Camera.fy: 200.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 16.0   # baseline x fx
Camera.RGB: 1
ThDepth: 35.0
DepthMapFactor: 5000.0

ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

TPU.maxKeypoints: 512
TPU.maxKeyframes: 96
TPU.maxPoints: 6144
TPU.maxFrames: 512
TPU.localBAPoints: 2048
"""
# the reference's Examples/Stereo/EuRoC.yaml rectification blocks (its
# `data:[` without a space included)
EUROC_BLOCKS = """
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0,
          435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
          0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
          -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
          0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
"""
N_CLI = 24
# the frames the fr1-lens and EuRoC CLI tests run (`--max-frames`), which
# keeps them at ~40 s each
N_CLI_SHORT = 16
# the reference's Examples/Monocular/TUM1.yaml lens (config.tum1_config)
FR1_LENS = dict(k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
                k3=1.163314)


def _chip_smoke():
    """chip_smoke.py, whose EuRoC inverse-rectification writer the tests
    share."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _yaml_matrix(key: str, m) -> str:
    m = np.atleast_2d(np.asarray(m, np.float64))
    return (f"{key}: !!opencv-matrix\n   rows: {m.shape[0]}\n   cols: "
            f"{m.shape[1]}\n   dt: d\n   data: ["
            + ", ".join(repr(float(x)) for x in m.ravel()) + "]\n")


def _small_euroc_rig(euroc_yaml: str):
    """The reference's EuRoC rig at the small camera: each side's D and R
    as the reference's, P the small camera's (RIGHT.P at its bf), K the
    reference's scaled as P is.  Returns ({side: (K, D, R, P)}, the YAML
    blocks)."""
    fs = read_opencv_yaml(euroc_yaml)
    s = CAM["fx"] / fs["LEFT.P"][0, 0]
    rig, text = {}, ""
    for side, tx in (("LEFT", 0.0), ("RIGHT", -16.0)):
        K0, P0 = fs[f"{side}.K"], fs[f"{side}.P"]
        cx = CAM["cx"] + (K0[0, 2] - P0[0, 2]) * s
        cy = CAM["cy"] + (K0[1, 2] - P0[1, 2]) * s
        K = np.array([[K0[0, 0] * s, 0.0, cx], [0.0, K0[1, 1] * s, cy],
                      [0.0, 0.0, 1.0]])
        P = np.array([[CAM["fx"], 0.0, CAM["cx"], tx],
                      [0.0, CAM["fy"], CAM["cy"], 0.0], [0.0, 0.0, 1.0, 0.0]])
        rig[side] = (K, fs[f"{side}.D"], fs[f"{side}.R"], P)
        text += (f"{side}.height: {CAM['height']}\n{side}.width: "
                 f"{CAM['width']}\n" + _yaml_matrix(f"{side}.D", rig[side][1])
                 + _yaml_matrix(f"{side}.K", K)
                 + _yaml_matrix(f"{side}.R", rig[side][2])
                 + _yaml_matrix(f"{side}.P", P))
    return rig, text


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sensor", [0, 1, 2])
@pytest.mark.parametrize("extra", ["", "euroc"])
def test_load_settings_matches_jax(tmp_path, sensor, extra):
    """The same SLAMConfig, field for field (every value is a parsed
    decimal, so equal as floats), with and without the EuRoC matrix
    blocks in the file."""
    p = tmp_path / "s.yaml"
    p.write_text(SETTINGS + (EUROC_BLOCKS if extra else ""))
    t = dataclasses.asdict(tload_settings(str(p), sensor))
    j = dataclasses.asdict(jload_settings(str(p), sensor))
    assert t == j
    assert t["cap"]["max_points"] == 6144 and t["camera"]["bf"] == \
        (16.0 if sensor else 0.0)


def test_read_opencv_yaml_matches_filestorage(tmp_path):
    """Every key as cv2.FileStorage reads it: scalars by real(), matrices
    by mat() with the same dtype and bits."""
    p = tmp_path / "s.yaml"
    p.write_text(SETTINGS + EUROC_BLOCKS)
    mine = read_opencv_yaml(str(p))
    fs = cv2.FileStorage(str(p), cv2.FILE_STORAGE_READ)
    keys = fs.root().keys()
    assert sorted(keys) == sorted(mine)
    for k in keys:
        node = fs.getNode(k)
        if node.isMap():
            ref = node.mat()
            assert mine[k].dtype == ref.dtype, k
            np.testing.assert_array_equal(mine[k], ref, err_msg=k)
        else:
            assert float(mine[k]) == node.real(), k
    with pytest.raises(FileNotFoundError):
        tload_settings(str(tmp_path / "absent.yaml"), 0)
    p.write_text("%YAML:1.0\nnode:\n   a: 1\n")
    with pytest.raises(ValueError, match="opencv-matrix"):
        read_opencv_yaml(str(p))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png(arr: np.ndarray, filters, interlace: int = 0) -> bytes:
    """A PNG of `arr` (8-bit gray / RGB / RGBA, 16-bit gray) whose row r
    uses filter type filters[r % len(filters)] (PNG spec section 9)."""
    H, W = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr
                               ).view(np.uint8).reshape(H, -1).astype(np.int64)
    bpp = ch * depth // 8
    out = []
    for r in range(H):
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        kind = filters[r % len(filters)]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (a + up) >> 1
        else:
            p = a + up - c
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc,
                                                                  up, c))
        out.append(bytes([kind]) + ((x - pred) & 255).astype(np.uint8)
                   .tobytes())

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                       interlace)) +
            chunk(b"IDAT", zlib.compress(b"".join(out))) +
            chunk(b"IEND", b""))


def _image(shape, dtype=np.uint8, seed=0):
    """A smooth image with noise: neighbouring samples correlate, as in a
    photograph, so every filter predicts something."""
    rng = np.random.RandomState(seed)
    H, W = shape[:2]
    yy, xx = np.mgrid[:H, :W]
    base = 127 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    if len(shape) == 3:
        base = base[..., None] + 30 * np.arange(shape[2])
    scale = 257 if dtype == np.uint16 else 1
    val = (base + rng.randn(*shape) * 8) * scale
    return np.clip(val, 0, np.iinfo(dtype).max).astype(dtype)


def _plain_only(monkeypatch):
    """Make the PNG reader unfilter with its plain version."""
    monkeypatch.setattr(png, "_native", lambda: None)


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "depth16"])
def test_png_reader_matches_cv2(tmp_path, kind, native, monkeypatch):
    """Files cv2.imwrite writes: the stored samples bit for bit
    (IMREAD_UNCHANGED; cv2 gives colour in BGR order), and the gray image
    bit for bit (IMREAD_GRAYSCALE: libpng's fixed-point weights)."""
    shape = {"gray": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4),
             "depth16": (37, 53)}[kind]
    arr = _image(shape, np.uint16 if kind == "depth16" else np.uint8)
    p = str(tmp_path / f"{kind}.png")
    cv2.imwrite(p, arr)
    assert png._native() is not None
    if not native:
        _plain_only(monkeypatch)
    px = png.read_png(p)
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = np.concatenate([ref[..., 2::-1], ref[..., 3:]], axis=2)
    assert px.dtype == ref.dtype
    np.testing.assert_array_equal(px, ref)
    if kind != "depth16":
        np.testing.assert_array_equal(png.to_gray(px),
                                      cv2.imread(p, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("kind", ["gray", "rgb", "depth16"])
def test_png_filters_match_cv2(tmp_path, filters, kind, monkeypatch):
    """Each filter type written here, read by the native helper, the plain
    version and cv2: all the same bits."""
    shape = {"gray": (23, 31), "rgb": (23, 31, 3), "depth16": (23, 31)}[kind]
    arr = _image(shape, np.uint16 if kind == "depth16" else np.uint8, 1)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_png(arr, filters))
    assert png._native() is not None
    nat = png.read_png(p)
    _plain_only(monkeypatch)
    plain = png.read_png(p)
    np.testing.assert_array_equal(nat, arr)
    np.testing.assert_array_equal(plain, arr)
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(nat, ref[..., ::-1] if ref.ndim == 3
                                  else ref)


def test_png_unsupported_files_raise(tmp_path):
    arr = _image((8, 8))
    cases = {"interlaced": _png(arr, (0,), interlace=1),
             "not a PNG": b"GIF89a" + bytes(32)}
    pal = bytearray(_png(arr, (0,)))
    pal[25] = 3                                # IHDR colour type: palette
    crc = zlib.crc32(bytes(pal[12:29])) & 0xFFFFFFFF
    pal[29:33] = struct.pack(">I", crc)
    cases["palette"] = bytes(pal)
    for name, data in cases.items():
        p = tmp_path / "bad.png"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            png.read_png(str(p))


def test_png_read_time_640x480(tmp_path):
    """A 640x480 gray frame as OpenCV writes it: decoded bit for bit; the
    ms per image printed (this machine's CPU)."""
    arr = _image((480, 640))
    p = str(tmp_path / "frame.png")
    cv2.imwrite(p, arr)
    png.imread_gray(p)
    t0 = time.perf_counter()
    for _ in range(5):
        img = png.imread_gray(p)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"png.imread_gray 640x480: {ms:.2f} ms per image "
          f"(native helper {native_build.load('png_unfilter') is not None})")
    np.testing.assert_array_equal(img, cv2.imread(p, 0).astype(np.float32))


def test_native_helper_falls_back_only_without_a_compiler(
        tmp_path, monkeypatch, capsys):
    """A compiler that is present and fails raises; with no compiler at all
    the reader takes its plain version and says so on stderr."""
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native_build.load("png_unfilter")
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    assert native_build.load("png_unfilter") is None
    assert "plain Python version" in capsys.readouterr().err
    arr = _image((9, 11))
    p = tmp_path / "f.png"
    p.write_bytes(_png(arr, (0, 1, 2, 3, 4)))
    np.testing.assert_array_equal(png.read_png(str(p)), arr)


# ---------------------------------------------------------------------------
# EuRoC rectification
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def euroc_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("euroc") / "EuRoC.yaml"
    p.write_text("%YAML:1.0\n" + EUROC_BLOCKS)
    return str(p)


def test_rectify_maps_match_cv2(euroc_yaml):
    """The undistort-rectify maps within 1e-3 px of
    cv2.initUndistortRectifyMap (the same float64 formula; measured 0)."""
    mine = tdatasets.euroc_rectify_maps(euroc_yaml)
    ref = jdatasets.euroc_rectify_maps(euroc_yaml)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape == (480, 752) and a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-3


def test_remap_matches_cv2(euroc_yaml):
    """A rendered 752x480 frame remapped through the left maps: within
    1e-4 of cv2.remap INTER_LINEAR (exact bilinear weights both; measured
    3.1e-5 on 0-255 values, float32 rounding), zeros where the map leaves
    the image."""
    m1x, m1y, _, _ = jdatasets.euroc_rectify_maps(euroc_yaml)
    cam = jconfig.CameraConfig(fx=435.2, fy=435.2, cx=367.5, cy=252.2,
                               width=752, height=480)
    img = synthetic.generate(cam, n_frames=1, n_points=4).images[0]
    mine = tdatasets.remap_bilinear(img, m1x, m1y)
    ref = cv2.remap(img, m1x, m1y, cv2.INTER_LINEAR)
    assert np.abs(mine - ref).max() <= 1e-4
    out = tdatasets.remap_bilinear(img, m1x - 2000.0, m1y)
    assert not out.any()


# ---------------------------------------------------------------------------
# dataset loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """TUM (mono + RGB-D, with an associations file), KITTI and EuRoC
    directories of 6 frames each, written by cv2."""
    root = tmp_path_factory.mktemp("layouts")
    rng = np.random.RandomState(0)
    imgs = [_image((24, 32), seed=i) for i in range(6)]
    t = 1305031102.175304 + np.arange(6) / 30.0
    tum = root / "tum"
    for d in ("rgb", "depth"):
        os.makedirs(tum / d)
    rgb, dep, assoc = [], [], []
    for i, img in enumerate(imgs):
        td = t[i] + rng.uniform(-0.015, 0.015)      # within 20 ms
        rp, dp = f"rgb/{t[i]:.6f}.png", f"depth/{td:.6f}.png"
        cv2.imwrite(str(tum / rp), np.repeat(img[..., None], 3, 2))
        cv2.imwrite(str(tum / dp), (img.astype(np.uint16) * 97))
        rgb.append(f"{t[i]:.6f} {rp}")
        dep.append(f"{td:.6f} {dp}")
        assoc.append(f"{t[i]:.6f} {rp} {td:.6f} {dp}")
    dep.append(f"{t[-1] + 1.0:.6f} depth/unpaired.png")
    (tum / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (tum / "depth.txt").write_text("# depth\n" + "\n".join(dep) + "\n")
    (tum / "assoc.txt").write_text("\n".join(assoc[:4]) + "\n")
    kitti = root / "kitti"
    for d in ("image_0", "image_1"):
        os.makedirs(kitti / d)
        for i, img in enumerate(imgs):
            cv2.imwrite(str(kitti / d / f"{i:06d}.png"), img)
    (kitti / "times.txt").write_text(
        "\n".join(f"{x:.6e}" for x in t - t[0]) + "\n")
    euroc = root / "euroc"
    for cam in ("cam0", "cam1"):
        os.makedirs(euroc / "mav0" / cam / "data")
        for i, img in enumerate(imgs[:5] if cam == "cam1" else imgs):
            cv2.imwrite(str(euroc / "mav0" / cam / "data" /
                            f"{int(t[i] * 1e9):019d}.png"), img)
    return root


def _items(xs):
    return [dataclasses.asdict(x) for x in xs]


@pytest.fixture(scope="module")
def euroc_full(tmp_path_factory):
    """A EuRoC directory of two 752x480 frame pairs (rendered at the
    rectified camera, written by cv2)."""
    root = tmp_path_factory.mktemp("euroc_full")
    cam = jconfig.CameraConfig(fx=435.2, fy=435.2, cx=367.5, cy=252.2,
                               width=752, height=480)
    imgs = synthetic.generate(cam, n_frames=2, n_points=4).images
    for c, order in (("cam0", (0, 1)), ("cam1", (1, 0))):
        os.makedirs(root / "mav0" / c / "data")
        for i, k in enumerate(order):
            cv2.imwrite(str(root / "mav0" / c / "data" /
                            f"{1403636579763555584 + i * 50000000}.png"),
                        np.clip(imgs[k], 0, 255).astype(np.uint8))
    return root


@pytest.mark.parametrize("name", ["tum_mono", "tum_rgbd", "tum_assoc",
                                  "kitti", "euroc", "euroc_rectified"])
def test_loader_items_match_jax(layouts, request, name):
    """The same items (timestamps, paths); then the frames a
    SequenceReader yields: images and depth maps bit for bit against the
    JAX reader's (cv2).  euroc_rectified: two 752x480 pairs rectified by
    the maps of the reference's EuRoC blocks, within 1e-4 of cv2.remap
    (as test_remap_matches_cv2; exact bilinear weights both, float32
    rounding apart: measured 3.05e-5)."""
    tum = str(layouts / "tum")
    calls = {
        "tum_mono": ("load_tum_mono", (tum,), "mono"),
        "tum_rgbd": ("load_tum_rgbd", (tum,), "rgbd"),
        "tum_assoc": ("load_tum_rgbd", (tum, os.path.join(tum, "assoc.txt")),
                      "rgbd"),
        "kitti": ("load_kitti_stereo", (str(layouts / "kitti"),), "stereo"),
        "euroc": ("load_euroc_stereo", (str(layouts / "euroc"),), "stereo"),
    }
    rect = (None, None)
    if name == "euroc_rectified":
        yaml = request.getfixturevalue("euroc_yaml")
        calls[name] = ("load_euroc_stereo",
                       (str(request.getfixturevalue("euroc_full")),),
                       "stereo")
        rect = (tdatasets.euroc_rectify_maps(yaml),
                jdatasets.euroc_rectify_maps(yaml))
    fn, args, sensor = calls[name]
    t_items = getattr(tdatasets, fn)(*args)
    j_items = getattr(jdatasets, fn)(*args)
    assert _items(t_items) == _items(j_items)
    assert len(t_items) == {"tum_assoc": 4, "euroc": 5,
                            "euroc_rectified": 2}.get(name, 6)
    tr = tdatasets.SequenceReader(t_items, sensor, depth_factor=5000.0,
                                  rectify=rect[0])
    jr = jdatasets.SequenceReader(j_items, sensor, depth_factor=5000.0,
                                  rectify=rect[1])
    n = 0
    for a, b in zip(tr, jr):
        n += 1
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if rect[0] is None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            else:
                assert np.abs(np.asarray(x) - np.asarray(y)).max() <= 1e-4
            assert np.asarray(x).dtype == np.asarray(y).dtype
    assert n == len(t_items)


# ---------------------------------------------------------------------------
# vocabulary text format and training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def descriptors():
    return np.random.RandomState(0).randint(0, 256, (1500, 32)
                                            ).astype(np.uint8)


def _same_vocab(a, b, exact_weight=True):
    for f in ("node_children", "node_desc", "word_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    if exact_weight:
        np.testing.assert_array_equal(a.word_weight, b.word_weight)
    else:
        # the text file holds a weight's shortest decimal repr: a float32
        # read back through float64 parsing rounds to the same float32,
        # the native parser's digit loop to within an ulp
        np.testing.assert_allclose(a.word_weight, b.word_weight, rtol=1e-6)
    assert (a.k, a.depth, a.n_words, a.levels_up) == \
        (b.k, b.depth, b.n_words, b.levels_up)


def test_train_vocabulary_matches_jax(descriptors):
    """The same seed draws the same k-medians seeds: identical trees and
    IDF weights, and the same k-medians for one level."""
    t = tvocab.train_vocabulary(descriptors, k=4, depth=3, seed=3,
                                levels_up=1)
    j = jvocab.train_vocabulary(descriptors, k=4, depth=3, seed=3,
                                levels_up=1)
    _same_vocab(t, j)
    bits = np.unpackbits(descriptors, axis=-1)
    tc, ta = tvocab._kmedians_binary(bits, 5, np.random.RandomState(1))
    jc, ja = jvocab._kmedians_binary(bits, 5, np.random.RandomState(1))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_orbvoc_text_round_trips_with_jax(tmp_path, descriptors, native):
    """A port-written ORBvoc text loads in JAX and a JAX-written one in the
    port, to the same vocabulary; the same file byte for byte from both
    writers; truncation to a shallower depth as JAX's."""
    voc = jvocab.train_vocabulary(descriptors, k=4, depth=3, seed=0,
                                  levels_up=1)
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jvocab.save_orbvoc_text(voc, pj)
    tvocab.save_orbvoc_text(tvocab.Vocabulary(**dataclasses.asdict(voc)), pt)
    assert open(pj).read() == open(pt).read()
    t = tvocab.load_orbvoc_text(pj, levels_up=1, native=native)
    _same_vocab(t, jvocab.load_orbvoc_text(pt, levels_up=1),
                exact_weight=False)
    _same_vocab(t, voc, exact_weight=False)
    t2 = tvocab.load_orbvoc_text(pj, levels_up=1, truncate_depth=2,
                                 native=native)
    _same_vocab(t2, jvocab.load_orbvoc_text(pj, levels_up=1,
                                            truncate_depth=2),
                exact_weight=False)
    assert t2.depth == 2


def test_native_orbvoc_parser_matches_python(tmp_path, descriptors):
    """The port's copy of the native parser (built with g++ into _build/)
    against its plain Python version: the same tree, weights within an
    ulp."""
    voc = tvocab.train_vocabulary(descriptors, k=5, depth=3, seed=1)
    p = str(tmp_path / "v.txt")
    tvocab.save_orbvoc_text(voc, p)
    assert native_build.load("voc_parser") is not None
    _same_vocab(tvocab.load_orbvoc_text(p, native=True),
                tvocab.load_orbvoc_text(p, native=False), exact_weight=False)


# ---------------------------------------------------------------------------
# the command-line entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory, euroc_yaml):
    """A TUM-mono and a KITTI directory of N_CLI frames of the small
    configuration's room (JAX renderer, written by cv2), and the settings
    file.  Beside them: tum_fr1/, the TUM sequence seen through the fr1
    lens (each pixel sampled from the render at its undistorted position,
    the port's `undistort_points`), with fr1.yaml; euroc/, the stereo pair
    as the raw images of the reference's EuRoC rig at the small camera
    (`_small_euroc_rig`: each raw pixel sampled from its eye's render at
    the rectified pixel it sees, chip_smoke.py's `euroc_raw_positions`),
    with euroc.yaml."""
    root = tmp_path_factory.mktemp("cli")
    cam = jconfig.CameraConfig(**CAM, bf=16.0)
    seq = synthetic.generate(cam, n_frames=N_CLI, n_points=300,
                             trajectory="xyz", seed=0)
    right = synthetic.generate(
        cam, n_frames=N_CLI, n_points=4, trajectory="xyz", seed=0,
        poses_override=synthetic.right_poses(seq.poses_twc,
                                             cam.baseline)).images
    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)
    os.makedirs(root / "tum" / "rgb")
    lines = []
    for f in range(N_CLI):
        rp = f"rgb/{seq.timestamps[f]:.6f}.png"
        cv2.imwrite(str(root / "tum" / rp), u8(seq.images[f]))
        lines.append(f"{seq.timestamps[f]:.6f} {rp}")
    (root / "tum" / "rgb.txt").write_text("\n".join(lines) + "\n")
    for d, imgs in (("image_0", seq.images), ("image_1", right)):
        os.makedirs(root / "kitti" / d)
        for f in range(N_CLI):
            cv2.imwrite(str(root / "kitti" / d / f"{f:06d}.png"), u8(imgs[f]))
    (root / "kitti" / "times.txt").write_text(
        "\n".join(f"{t:.6e}" for t in seq.timestamps) + "\n")
    yaml = root / "settings.yaml"
    yaml.write_text(SETTINGS)
    # the fr1 lens: every undistorted position lies inside the render
    W, H = CAM["width"], CAM["height"]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    g = tcamera.undistort_points(
        torch.tensor([CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]]),
        torch.tensor([FR1_LENS[k] for k in ("k1", "k2", "p1", "p2", "k3")]),
        torch.as_tensor(np.stack([u, v], -1))).numpy()
    assert g.min() >= 0 and g[..., 0].max() <= W - 1 and \
        g[..., 1].max() <= H - 1
    os.makedirs(root / "tum_fr1" / "rgb")
    for f in range(N_CLI):
        cv2.imwrite(str(root / "tum_fr1" / f"rgb/{seq.timestamps[f]:.6f}.png"),
                    u8(tdatasets.remap_bilinear(seq.images[f], g[..., 0],
                                                g[..., 1])))
    (root / "tum_fr1" / "rgb.txt").write_text("\n".join(lines) + "\n")
    lens = "".join(f"Camera.{k}: {x}\n" for k, x in FR1_LENS.items())
    (root / "fr1.yaml").write_text(SETTINGS.replace(
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n",
        lens))
    # the EuRoC rig
    rig, blocks = _small_euroc_rig(euroc_yaml)
    raw_positions = _chip_smoke().euroc_raw_positions
    for side, c, imgs in (("LEFT", "cam0", seq.images),
                          ("RIGHT", "cam1", right)):
        px, py = raw_positions(*rig[side], (W, H))
        os.makedirs(root / "euroc" / "mav0" / c / "data")
        for f in range(N_CLI):
            cv2.imwrite(str(root / "euroc" / "mav0" / c / "data" /
                            f"{round(seq.timestamps[f] * 1e9):019d}.png"),
                        u8(tdatasets.remap_bilinear(imgs[f], px, py)))
    (root / "euroc.yaml").write_text(SETTINGS + blocks)
    return root, seq, str(yaml)


def _tum_ate(path, seq, align_scale):
    rows = np.loadtxt(path, ndmin=2)
    est = np.concatenate([rows[:, [7, 4, 5, 6]], rows[:, 1:4]], axis=1)
    ie, ig = evaluate.match_timestamps(rows[:, 0], seq.timestamps)
    return evaluate.ate_rmse(est[ie], seq.poses_twc[ig],
                             align_scale=align_scale), len(ie)


def test_cli_tum_mono_matches_jax(cli_dirs, tmp_path):
    """`run --dataset tum --sensor mono` on the same directory: both write
    TUM files that track >= 70% of the frames under test_io_ingest's
    0.03 m gate (scale-aligned) and whose ATEs are within 0.01 m.  The
    two-view initialisations draw different RANSAC samples, so the
    trajectories agree only to that."""
    root, seq, yaml = cli_dirs
    args = ["run", "--dataset", "tum", "--sensor", "mono", "--path",
            str(root / "tum"), "--settings", yaml]
    jcli.main(args + ["--output", str(tmp_path / "j.txt")])
    slam = tcli.main(args + ["--output", str(tmp_path / "t.txt"),
                             "--device", "cpu"])
    assert slam.device.type == "cpu"
    ja, jn = _tum_ate(tmp_path / "j.txt", seq, True)
    ta, tn = _tum_ate(tmp_path / "t.txt", seq, True)
    assert tn >= 0.7 * N_CLI and jn >= 0.7 * N_CLI, (tn, jn)
    assert ta <= 0.03 and abs(ta - ja) <= 0.01, (ta, ja)


def test_cli_kitti_stereo_matches_jax(cli_dirs, tmp_path):
    """`run --dataset kitti --sensor stereo`: KITTI-format files (12
    numbers a tracked frame) with the same frames tracked and every pose
    entry within 2e-3 (stereo initialisation has no random draws; the
    sessions part only by float round-off through their pose LMs and BAs).
    Without --device the port's CLI runs on the card, and raises without
    one."""
    root, seq, yaml = cli_dirs
    args = ["run", "--dataset", "kitti", "--sensor", "stereo", "--path",
            str(root / "kitti"), "--settings", yaml]
    jcli.main(args + ["--output", str(tmp_path / "j.txt")])
    tcli.main(args + ["--output", str(tmp_path / "t.txt"), "--device",
                      "cpu"])
    j, t = np.loadtxt(tmp_path / "j.txt"), np.loadtxt(tmp_path / "t.txt")
    assert t.shape == j.shape and t.shape[1] == 12
    assert t.shape[0] >= 0.9 * N_CLI
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(args + ["--output", str(tmp_path / "x.txt")])


def test_cli_tum_mono_with_lens_matches_jax(cli_dirs, tmp_path):
    """`run --dataset tum --sensor mono` over the first N_CLI_SHORT frames
    of the TUM sequence seen through the fr1 lens, the lens in the
    settings (keypoints undistorted in the step):
    test_cli_tum_mono_matches_jax's checks."""
    root, seq, _ = cli_dirs
    args = ["run", "--dataset", "tum", "--sensor", "mono", "--path",
            str(root / "tum_fr1"), "--settings", str(root / "fr1.yaml"),
            "--max-frames", str(N_CLI_SHORT)]
    jcli.main(args + ["--output", str(tmp_path / "j.txt")])
    slam = tcli.main(args + ["--output", str(tmp_path / "t.txt"),
                             "--device", "cpu"])
    assert slam.cfg.camera.k3 == FR1_LENS["k3"]
    ja, jn = _tum_ate(tmp_path / "j.txt", seq, True)
    ta, tn = _tum_ate(tmp_path / "t.txt", seq, True)
    assert tn >= 0.7 * N_CLI_SHORT and jn >= 0.7 * N_CLI_SHORT, (tn, jn)
    assert ta <= 0.03 and abs(ta - ja) <= 0.01, (ta, ja)


def test_cli_euroc_stereo_matches_jax(cli_dirs, tmp_path):
    """`run --dataset euroc --sensor stereo` over the first N_CLI_SHORT
    raw distorted frame pairs, each package rectifying them on the host
    by the settings' LEFT/RIGHT blocks: TUM files with the same frames
    tracked and every pose entry within 2e-3, as
    test_cli_kitti_stereo_matches_jax (the readers' images, 3e-5 apart,
    flip no keypoint here: the entries measured 1.8e-5 apart at most),
    and a metric ATE under test_stereo_e2e's 0.06 m."""
    root, seq, _ = cli_dirs
    args = ["run", "--dataset", "euroc", "--sensor", "stereo", "--path",
            str(root / "euroc"), "--settings", str(root / "euroc.yaml"),
            "--max-frames", str(N_CLI_SHORT)]
    jcli.main(args + ["--output", str(tmp_path / "j.txt")])
    tcli.main(args + ["--output", str(tmp_path / "t.txt"), "--device",
                      "cpu"])
    j, t = np.loadtxt(tmp_path / "j.txt"), np.loadtxt(tmp_path / "t.txt")
    assert t.shape == j.shape and t.shape[1] == 8
    assert t.shape[0] >= 0.9 * N_CLI_SHORT
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    ta, _ = _tum_ate(tmp_path / "t.txt", seq, False)
    assert ta <= 0.06, ta


def test_cli_euroc_mono_reads_cam0_raw(cli_dirs, tmp_path):
    """`run --dataset euroc --sensor mono` with settings in the form of
    the reference's Monocular/EuRoC.yaml (cam0's own lens, no LEFT/RIGHT
    blocks) reads cam0's raw images and builds no rectification maps: the
    frames the session gets are the PNGs' pixels."""
    root, seq, yaml = cli_dirs
    mono_yaml = tmp_path / "mono.yaml"
    mono_yaml.write_text(open(yaml).read().replace(
        "Camera.k1: 0.0\nCamera.k2: 0.0\n",
        "Camera.k1: -0.28340811\nCamera.k2: 0.07395907\n"))
    seen = []
    track = tcli._track
    try:
        tcli._track = lambda slam, sensor, data: (seen.append(data[0]),
                                                  track(slam, sensor, data))
        slam = tcli.main(["run", "--dataset", "euroc", "--sensor", "mono",
                          "--path", str(root / "euroc"), "--settings",
                          str(mono_yaml), "--output",
                          str(tmp_path / "t.txt"), "--max-frames", "3",
                          "--device", "cpu"])
    finally:
        tcli._track = track
    assert slam.cfg.camera.k1 == -0.28340811 and len(seen) == 3
    first = sorted(os.listdir(root / "euroc" / "mav0" / "cam0" / "data"))[0]
    np.testing.assert_array_equal(
        seen[0], cv2.imread(str(root / "euroc" / "mav0" / "cam0" / "data" /
                                first), 0).astype(np.float32))
