"""A PNG reader and writer in numpy and zlib, for machines without OpenCV
or PIL.

Reads what the datasets the reference runs on hold: 8-bit gray images,
8-bit RGB / RGBA / gray-alpha images (converted to gray as
`cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does) and 16-bit gray depth maps
(big-endian samples, returned exactly).  Interlaced, palette, sub-byte and
16-bit colour files raise ValueError.

`write_png` writes 8-bit gray, 8-bit RGB and 16-bit gray images (every
row with the Sub filter).

Unfiltering (PNG filter types 0-4) runs in the native helper
`native/png_unfilter.cpp` (built with g++ at first use), or, where no C++
compiler is present, in `unfilter_plain`, its plain version (rows in
numpy, the pixels of Average and Paeth rows one at a time: seconds for a
640x480 image).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from orb_slam2_tpu_torch import native_build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's fixed-point RGB -> gray weights as OpenCV sets them
# (png_set_rgb_to_gray(png, 1, 0.299, 0.587): 15-bit integers, the
# double weights truncated through libpng's 1e-5 fixed point); libpng
# truncates the weighted sum (no rounding term)
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def unfilter_plain(raw: np.ndarray, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters: `raw` [height * (stride + 1)] u8 ->
    [height, stride] u8."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, x = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = x.copy()
        elif kind == 1:      # Sub: a running sum per byte of the pixel
            cur = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)
        elif kind == 2:
            cur = x + prev
        elif kind in (3, 4):
            cur = x.astype(np.int32)
            p = prev.astype(np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = p[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + p[i]) >> 1
                else:
                    est = a + p[i] - c
                    pa, pb, pc = abs(est - a), abs(est - p[i]), abs(est - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (p[i] if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def _native():
    """The native helper with its C signature declared, or None when no
    compiler is present."""
    lib = native_build.load("png_unfilter")
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_long, ctypes.c_long,
                                     ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
    return lib


def unfilter(raw: np.ndarray, height: int, stride: int,
             bpp: int) -> np.ndarray:
    """`unfilter_plain` through the native helper where it can be built."""
    lib = _native()
    if lib is None:
        return unfilter_plain(raw, height, stride, bpp)
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.empty((height, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.png_unfilter(raw.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
                          height, stride, bpp)
    if rc != 0:
        raise ValueError(f"PNG row {-rc - 1}: unknown filter type")
    return out


def read_png(path: str) -> np.ndarray:
    """The stored samples: [H, W] for gray, [H, W, C] otherwise (RGB, RGBA,
    gray-alpha in file order); uint8, or uint16 for 16-bit files."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression / filter method")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         "supported")
    ch = _CHANNELS[ctype]
    if depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {ctype} is "
                         "not supported")
    nbytes = depth // 8
    bpp, stride = ch * nbytes, W * ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, not "
                         f"{H * (stride + 1)}")
    px = unfilter(raw, H, stride, bpp)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(H, W)
    return px.reshape(H, W) if ch == 1 else px.reshape(H, W, ch)


def to_gray(px: np.ndarray) -> np.ndarray:
    """Samples of `read_png` -> [H, W] 8-bit gray as OpenCV's
    IMREAD_GRAYSCALE gives it: RGB by libpng's fixed-point weights (alpha
    dropped), 16-bit gray by its high byte."""
    if px.dtype == np.uint16:
        return (px >> 8).astype(np.uint8)
    if px.ndim == 2:
        return px
    if px.shape[2] == 2:                  # gray + alpha
        return px[..., 0]
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """A PNG as an [H, W] float32 gray image of 0-255 values."""
    return to_gray(read_png(path)).astype(np.float32)


def write_png(path: str, arr: np.ndarray) -> str:
    """Write an 8-bit gray [H, W], 8-bit RGB [H, W, 3] or 16-bit gray
    [H, W] array to `path` as a PNG, every row with the Sub filter;
    returns the path."""
    arr = np.asarray(arr)
    ok = (arr.dtype == np.uint8 and (arr.ndim == 2 or (
        arr.ndim == 3 and arr.shape[2] == 3))) or (
        arr.dtype == np.uint16 and arr.ndim == 2)
    if not ok:
        raise ValueError(f"cannot write a {arr.dtype} array of shape "
                         f"{arr.shape} as PNG")
    H, W = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else 3
    depth = 16 if arr.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr
                               ).view(np.uint8).reshape(H, -1)
    bpp = ch * depth // 8
    sub = raw.copy()
    sub[:, bpp:] = raw[:, bpp:] - raw[:, :-bpp]         # wraps mod 256
    body = np.concatenate([np.ones((H, 1), np.uint8), sub], 1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    data = (_SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                       {1: 0, 3: 2}[ch], 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path
