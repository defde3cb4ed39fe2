"""A small numpy rasteriser for the port's headless renderers (the JAX
package draws with matplotlib, which the card's machine does not have).

A renderer describes what it draws as primitives in data coordinates,
`Marks` (scatter markers), `Line` (polylines) and `Text`, collected in a
`Scene`; `render(scene)` turns a scene into an 8-bit RGB image.  The
primitives carry matplotlib's own arguments (colour specs, marker areas in
points^2, line widths in points), so they can be held against the calls
the JAX renderers make.

Axes kinds:
  "image"  data units are canvas pixels (imshow's extent [0, w, h, 0]);
  "2d"     equal-aspect x-y axes fitted into the canvas, with a frame;
  "3d"     an orthographic view of a box of aspect 4:4:3 (matplotlib's
           default), each axis scaled to its data range, seen from
           `view = (elev, azim)` in degrees with matplotlib's `view_init`
           convention (the eye at azimuth `azim` about the vertical third
           axis, `elev` above the horizontal plane).
Draw order follows matplotlib's z-order: image, marks, lines, text.
Text uses a 5x7 bitmap font for ASCII 32-126, defined below.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

# matplotlib's values of the named colours the renderers use
_NAMED = {
    "tab:blue": "#1f77b4", "tab:orange": "#ff7f0e", "tab:green": "#2ca02c",
    "tab:red": "#d62728", "lime": "#00ff00", "deepskyblue": "#00bfff",
    "black": "#000000", "white": "#ffffff",
}


def rgb(spec: str) -> np.ndarray:
    """[3] float colour in [0, 1] of a matplotlib colour spec: a gray level
    string ("0.55"), a name of `_NAMED` or "#rrggbb"."""
    spec = _NAMED.get(spec, spec)
    if spec.startswith("#") and len(spec) == 7:
        return np.array([int(spec[i:i + 2], 16) / 255.0 for i in (1, 3, 5)])
    g = float(spec)
    if not 0.0 <= g <= 1.0:
        raise ValueError(f"gray level {spec} outside [0, 1]")
    return np.full(3, g)


class Marks(NamedTuple):
    """Scatter markers at `pts` [N, 2 or 3]."""
    pts: np.ndarray
    color: str
    marker: str             # ".", "o" or "s"
    size: float             # area in points^2 (scatter's `s`)
    filled: bool = True
    width: float = 0.0      # outline width in points (hollow markers)
    alpha: float = 1.0
    label: Optional[str] = None


class Line(NamedTuple):
    """A polyline through `pts` [N, 2 or 3]."""
    pts: np.ndarray
    color: str
    width: float            # points
    alpha: float = 1.0
    style: str = "-"        # "-" or "--"
    label: Optional[str] = None


class Text(NamedTuple):
    """`text` with its left baseline at data point `xy`."""
    xy: Tuple[float, float]
    text: str
    color: str
    size: float = 9.0       # points
    box: Optional[str] = None
    box_alpha: float = 1.0


class Scene(NamedTuple):
    size: Tuple[int, int]               # canvas (width, height) in pixels
    dpi: float
    axes: str                           # "image", "2d" or "3d"
    marks: Sequence[Marks] = ()
    lines: Sequence[Line] = ()
    texts: Sequence[Text] = ()
    image: Optional[np.ndarray] = None  # gray [h, w], 0-255 ("image" axes)
    view: Tuple[float, float] = (30.0, -60.0)
    labels: Tuple[str, ...] = ()
    title: Optional[str] = None
    legend: bool = False


# ---------------------------------------------------------------------------
# the 5x7 font: per glyph 5 column bytes, bit 0 the top row
# ---------------------------------------------------------------------------

_FONT_HEX = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 "
    "3649552250 0005030000 001c224100 0041221c00 14083e0814 08083e0808 "
    "0050300000 0808080808 0060600000 2010080402 3e5149453e 00427f4000 "
    "4261514946 2141454b31 1814127f10 2745454539 3c4a494930 0171090503 "
    "3649494936 064949291e 0036360000 0056360000 0814224100 1414141414 "
    "0041221408 0201510906 324979413e 7e1111117e 7f49494936 3e41414122 "
    "7f4141221c 7f49494941 7f09090901 3e4149497a 7f0808087f 00417f4100 "
    "2040413f01 7f08142241 7f40404040 7f020c027f 7f0408107f 3e4141413e "
    "7f09090906 3e4151215e 7f09192946 4649494931 01017f0101 3f4040403f "
    "1f2040201f 3f4038403f 6314081463 0708700807 6151494543 007f414100 "
    "0204081020 0041417f00 0402010204 4040404040 0001020400 2054545478 "
    "7f48444438 3844444420 384444487f 3854545418 087e090102 0c5252523e "
    "7f08040478 00447d4000 2040443d00 7f10284400 00417f4000 7c04180478 "
    "7c08040478 3844444438 7c14141408 081414187c 7c08040408 4854545420 "
    "043f444020 3c4040207c 1c2040201c 3c4030403c 4428102844 0c5050503c "
    "4464544c44 0008364100 00007f0000 0041360800 0201020402")
_FONT = np.array([[[(int(g[2 * c:2 * c + 2], 16) >> r) & 1
                    for c in range(5)] for r in range(7)]
                  for g in _FONT_HEX.split()], bool)        # [95, 7, 5]


def glyphs(text: str) -> np.ndarray:
    """[7, 6 * len(text)] bool bitmap of `text` (one blank column after
    each glyph); characters outside ASCII 32-126 draw as '?'."""
    idx = [ord(c) - 32 if 32 <= ord(c) <= 126 else ord("?") - 32
           for c in text]
    if not idx:
        return np.zeros((7, 0), bool)
    cells = np.concatenate([_FONT[idx], np.zeros((len(idx), 7, 1), bool)],
                           2)
    return cells.transpose(1, 0, 2).reshape(7, -1)


# ---------------------------------------------------------------------------
# canvas
# ---------------------------------------------------------------------------

class Canvas:
    """A float RGB canvas [H, W, 3] in [0, 1], white, with alpha blending
    of boolean coverage masks."""

    def __init__(self, width: int, height: int):
        self.px = np.ones((height, width, 3))

    @property
    def shape(self):
        return self.px.shape[:2]

    def blend(self, mask: np.ndarray, color: str, alpha: float = 1.0):
        c = rgb(color)
        self.px[mask] = self.px[mask] * (1.0 - alpha) + c * alpha

    def mask_of(self, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Coverage mask of the integer pixels (ys, xs) inside the canvas."""
        H, W = self.shape
        m = np.zeros((H, W), bool)
        ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        m[ys[ok], xs[ok]] = True
        return m

    def to_uint8(self) -> np.ndarray:
        return np.clip(np.round(self.px * 255.0), 0, 255).astype(np.uint8)


def _brush(width: int) -> np.ndarray:
    """[n, 2] (dy, dx) offsets of a width x width square brush."""
    r = np.arange(width) - (width - 1) // 2
    return np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)


def _lw_px(points: float, dpi: float) -> int:
    return max(1, int(round(points * dpi / 72.0)))


def draw_marks(cv: Canvas, xy: np.ndarray, m: Marks, dpi: float):
    """Markers at pixel coordinates xy [N, 2] (x right, y down)."""
    if not len(xy):
        return
    d = math.sqrt(m.size) * dpi / 72.0            # marker extent in pixels
    if m.marker == ".":
        d *= 0.5
    r = max(0, int(round(d / 2.0)))
    off = np.arange(-r, r + 1)
    dy, dx = (a.reshape(-1) for a in np.meshgrid(off, off, indexing="ij"))
    inside = np.ones_like(dy, bool)
    if m.marker in ("o", "."):
        inside = dy * dy + dx * dx <= r * r + r
    if not m.filled:
        t = _lw_px(m.width, dpi)
        ring = np.maximum(np.abs(dy), np.abs(dx)) > r - t
        if m.marker != "s":
            ring = dy * dy + dx * dx > (r - t) * (r - t) + (r - t)
        inside &= ring
    dy, dx = dy[inside], dx[inside]
    c = np.floor(xy).astype(np.int64)
    cv.blend(cv.mask_of((c[:, 1:2] + dy).reshape(-1),
                        (c[:, 0:1] + dx).reshape(-1)), m.color, m.alpha)


def line_pixels(xy: np.ndarray, ln: Line, dpi: float):
    """(ys, xs) of the pixels a polyline through pixel coordinates xy
    [N, 2] covers; "--" is 6 px on, 4 px off."""
    if len(xy) < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pts = []
    for a, b in zip(xy[:-1], xy[1:]):
        n = int(math.ceil(np.abs(b - a).max() * 2.0)) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        seg = a + t * (b - a)
        if ln.style == "--":
            s = np.linalg.norm(b - a) * t[:, 0]
            seg = seg[(s % 10.0) < 6.0]
        pts.append(seg)
    p = np.floor(np.concatenate(pts)).astype(np.int64)
    br = _brush(_lw_px(ln.width, dpi))
    return ((p[:, 1:2] + br[None, :, 0]).reshape(-1),
            (p[:, 0:1] + br[None, :, 1]).reshape(-1))


def draw_lines(cv: Canvas, lines: Sequence[Tuple[np.ndarray, Line]],
               dpi: float):
    """Polylines (pixel coordinates, style) in order; a run of lines of
    one colour, width, alpha and style is blended as one coverage mask, so
    alpha applies once per pixel of the run."""
    run, key = [], None
    for xy, ln in list(lines) + [(None, None)]:
        k = None if ln is None else (ln.color, ln.width, ln.alpha, ln.style)
        if run and k != key:
            ys = np.concatenate([r[0] for r in run])
            xs = np.concatenate([r[1] for r in run])
            cv.blend(cv.mask_of(ys, xs), key[0], key[2])
            run = []
        if ln is not None:
            run.append(line_pixels(xy, ln, dpi))
            key = k


def font_scale(size_pt: float, dpi: float) -> int:
    return max(1, int(round(size_pt * dpi / 72.0 / 9.0)))


def draw_text(cv: Canvas, x: float, y: float, text: str, color: str,
              scale: int = 1, box: Optional[str] = None,
              box_alpha: float = 1.0, anchor: str = "left"):
    """`text` with its baseline at pixel y, starting at x ("left"), centred
    on it ("center") or ending at it ("right"), on an optional background
    box 2 px around the glyphs."""
    bm = glyphs(text)
    if scale > 1:
        bm = bm.repeat(scale, 0).repeat(scale, 1)
    h, w = bm.shape
    x0 = int(math.floor(x)) - {"left": 0, "center": w // 2,
                               "right": w}[anchor]
    y0 = int(math.floor(y)) - h + 1
    if box is not None:
        H, W = cv.shape
        m = np.zeros((H, W), bool)
        m[max(y0 - 2, 0):max(y0 + h + 2, 0), max(x0 - 2, 0):max(x0 + w + 1, 0)
          ] = True
        cv.blend(m, box, box_alpha)
    ys, xs = np.nonzero(bm)
    cv.blend(cv.mask_of(ys + y0, xs + x0), color)


# ---------------------------------------------------------------------------
# axes: data coordinates -> pixels
# ---------------------------------------------------------------------------

def view_basis(elev: float, azim: float) -> Tuple[np.ndarray, np.ndarray]:
    """Screen right and up unit vectors of matplotlib's view at (elev,
    azim) degrees: the eye direction w = (cos e cos a, cos e sin a, sin e),
    right = (0, 0, 1) x w, up = w x right."""
    e, a = math.radians(elev), math.radians(azim)
    w = np.array([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a),
                  math.sin(e)])
    u = np.cross([0.0, 0.0, 1.0], w)
    if np.linalg.norm(u) < 1e-9:                  # looking straight down/up
        u = np.array([-math.sin(a), math.cos(a), 0.0])
    u /= np.linalg.norm(u)
    return u, np.cross(w, u)


class _Fit:
    """Affine map of screen coordinates (x right, y up) into a pixel box."""

    def __init__(self, lo, hi, box, equal: bool):
        (x0, y0, x1, y1) = box
        span = np.maximum(np.asarray(hi, float) - lo, 1e-12)
        sx, sy = (x1 - x0) / span[0], (y1 - y0) / span[1]
        if equal:
            sx = sy = min(sx, sy)
        self.s = np.array([sx, -sy])
        mid = (np.asarray(lo, float) + hi) / 2.0
        self.c = np.array([(x0 + x1) / 2.0, (y0 + y1) / 2.0]) - mid * self.s

    def __call__(self, p: np.ndarray) -> np.ndarray:
        return p * self.s + self.c


def _limits(arrays, dims: int):
    pts = [np.asarray(a, float).reshape(-1, dims) for a in arrays if len(a)]
    if not pts:
        return np.zeros(dims), np.ones(dims)
    p = np.concatenate(pts)
    p = p[np.isfinite(p).all(1)]
    if not len(p):
        return np.zeros(dims), np.ones(dims)
    lo, hi = p.min(0), p.max(0)
    pad = np.maximum((hi - lo) * 0.05, 1e-6)
    return lo - pad, hi + pad


def _fmt(v: float) -> str:
    return f"{v:.3g}"


def render(scene: Scene) -> np.ndarray:
    """The scene as an 8-bit RGB image [H, W, 3]."""
    W, H = scene.size
    dpi = scene.dpi
    cv = Canvas(W, H)
    fs = font_scale(10.0, dpi)
    if scene.axes == "image":
        to_px = lambda p: np.asarray(p, float)[:, :2]
        if scene.image is not None:
            img = np.asarray(scene.image, float)
            h, w = img.shape[:2]
            g = np.clip(np.floor(np.clip(img, 0, 255) / 255.0 * 256.0), 0,
                        255) / 255.0
            cv.px[:min(h, H), :min(w, W)] = g[:H, :W, None]
    elif scene.axes == "2d":
        lo, hi = _limits([m.pts for m in scene.marks] +
                         [ln.pts for ln in scene.lines], 2)
        box = (70, 30 + 10 * fs, W - 30, H - 60)
        fit = _Fit(lo, hi, box, equal=True)
        to_px = lambda p: fit(np.asarray(p, float))
        (bx0, by1), (bx1, by0) = fit(lo), fit(hi)
        frame = np.array([[bx0, by0], [bx1, by0], [bx1, by1], [bx0, by1],
                          [bx0, by0]])
        draw_lines(cv, [(frame, Line(frame, "black", 0.8))], dpi)
        for v, (x, y) in ((lo[0], (bx0, by1 + 12 * fs)),
                          (hi[0], (bx1, by1 + 12 * fs))):
            draw_text(cv, x, y, _fmt(v), "black", fs, anchor="center")
        draw_text(cv, bx0 - 6, by1, _fmt(lo[1]), "black", fs, anchor="right")
        draw_text(cv, 4, by0 + 8 * fs, _fmt(hi[1]), "black", fs)
        if len(scene.labels) >= 2:
            draw_text(cv, (bx0 + bx1) / 2, by1 + 24 * fs, scene.labels[0],
                      "black", fs, anchor="center")
            draw_text(cv, 4, (by0 + by1) / 2, scene.labels[1], "black", fs)
    else:
        u, v = view_basis(*scene.view)
        lo, hi = _limits([m.pts for m in scene.marks] +
                         [ln.pts for ln in scene.lines], 3)
        aspect = np.array([4.0, 4.0, 3.0])
        norm = lambda p: ((np.asarray(p, float) - (lo + hi) / 2.0) /
                          (hi - lo) * aspect)
        screen = lambda p: np.stack([norm(p) @ u, norm(p) @ v], -1)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        sc = screen(corners)
        fit = _Fit(sc.min(0), sc.max(0), (40, 40 + 10 * fs, W - 40, H - 40),
                   equal=True)
        to_px = lambda p: fit(screen(p))
        # the three axes from the low corner, with their labels
        for k in range(3):
            end = lo.copy()
            end[k] = hi[k]
            seg = to_px(np.stack([lo, end]))
            draw_lines(cv, [(seg, Line(seg, "0.6", 0.8))], dpi)
            if k < len(scene.labels):
                draw_text(cv, seg[1, 0] + 4, seg[1, 1], scene.labels[k],
                          "0.3", fs)
    for m in scene.marks:
        draw_marks(cv, to_px(m.pts), m, dpi)
    draw_lines(cv, [(to_px(ln.pts), ln) for ln in scene.lines], dpi)
    for t in scene.texts:
        x, y = to_px(np.array([t.xy], float))[0]
        draw_text(cv, x, y, t.text, t.color, font_scale(t.size, dpi), t.box,
                  t.box_alpha)
    if scene.legend:
        entries = [(m.label, m.color, True) for m in scene.marks if m.label]
        entries += [(ln.label, ln.color, False) for ln in scene.lines
                    if ln.label]
        y = 20 + 10 * fs
        for label, color, is_mark in entries:
            x = 12
            m = np.zeros(cv.shape, bool)
            if is_mark:
                m[y - 6 * fs:y, x:x + 6 * fs] = True
            else:
                m[y - 4 * fs:y - 2 * fs, x:x + 12 * fs] = True
            cv.blend(m, color)
            draw_text(cv, x + 16 * fs, y, label, "black", fs)
            y += 10 * fs
    if scene.title:
        draw_text(cv, W / 2, 4 + 8 * fs, scene.title, "black", fs,
                  anchor="center")
    return cv.to_uint8()
