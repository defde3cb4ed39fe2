"""The plain reference that decides `correct`.

Plain numpy and torch only: it imports nothing of the program, and takes
nothing the program made but the outputs it judges.  It works out again,
from the benchmark's own inputs (the rendered images, the frozen
vocabulary and BRIEF pattern, the room and the ground-truth trajectory):

- extraction: ORB's steered BRIEF (Rublee et al., ICCV 2011: the
  intensity-centroid angle, the pattern rotated to the nearest of 30
  angle bins) at each keypoint the program reports, on the reference's
  own pyramid of the same image: the cascade of antialiased bilinear
  resizes (a triangle kernel stretched by the scale, as
  `jax.image.resize(..., "bilinear")` computes it), each level
  zero-padded to the image's size and blurred by a separable Gaussian
  (the configuration's ksize and sigma) that wraps at the padded plane's
  edges, as the port's design states;
- place recognition: DBoW2's transform (descend the k-ary tree by the
  least Hamming distance, the first child winning a tie; TF-IDF counts,
  L1-normalised) of each keyframe's descriptors, and ORB-SLAM2's loop
  detection (DBoW2's L1 score, the covisibility gates and the group
  accumulation) over those rows with the program's covisibility weights
  (the one piece of the program's state it takes: the covisibility graph
  is the mapping stages' bookkeeping, not an output it can rebuild);
- tracking and mapping: the trajectory's ATE against the renderer's
  ground truth after a rigid (Umeyama, no scale) alignment, and (read by
  `control.py` only) each map point's distance to the nearest plane of
  the room.

Every function takes a `dtype`: float32 (float64 for the geometry) is the
reference; a lower one is the control that `control.py` reads.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PATCH, HALF, N_BITS, Q_BINS = 31, 15, 256, 30


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def brief_pattern() -> np.ndarray:
    """[256, 2, 2] (pair, point, (dy, dx)): the benchmark's frozen copy of
    the port's learned pattern."""
    return np.load(os.path.join(HERE, "data", "brief_pattern.npy")
                   ).astype(np.int64)


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(n_levels)]


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of an antialiased bilinear resize along one
    axis: output sample j sits at (j + 0.5) n_in / n_out - 0.5 and takes
    the inputs under a triangle of half-width max(n_in / n_out, 1),
    normalised; float64."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    at = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(at[None, :] - np.arange(n_in)[:, None])
                   / width)
    tot = w.sum(0, keepdims=True)
    return np.where(tot > 0, w / np.where(tot > 0, tot, 1.0), 0.0)


def gaussian(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize) - ksize // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blurred_levels(img: torch.Tensor, n_levels: int, scale: float,
                   ksize: int, sigma: float, dtype=torch.float32):
    """The blurred levels [L, H, W] of one image [H, W] (each level in the
    top-left corner of a zero plane of the image's size) and the levels'
    shapes."""
    H, W = img.shape
    dev = img.device
    shapes = level_shapes(H, W, n_levels, scale)
    cur = img.to(dtype)
    planes = torch.zeros((n_levels, H, W), dtype=dtype, device=dev)
    for i, (h, w) in enumerate(shapes):
        if i:
            ph, pw = shapes[i - 1]
            if ph != h:
                cur = torch.as_tensor(resize_matrix(ph, h).T, dtype=dtype,
                                      device=dev) @ cur
            if pw != w:
                cur = cur @ torch.as_tensor(resize_matrix(pw, w),
                                            dtype=dtype, device=dev)
        planes[i, :h, :w] = cur
    k = gaussian(ksize, sigma)
    r = ksize // 2
    rows = sum(torch.roll(planes, i - r, 1) * torch.tensor(
        float(k[i]), dtype=dtype, device=dev) for i in range(ksize))
    out = sum(torch.roll(rows, i - r, 2) * torch.tensor(
        float(k[i]), dtype=dtype, device=dev) for i in range(ksize))
    return out, shapes


def steered_brief(blurred: torch.Tensor, shapes, level: torch.Tensor,
                  kx: torch.Tensor, ky: torch.Tensor):
    """Packed descriptors [K, 32] u8 and angles [K] at integer level
    coordinates (kx, ky) on `level` [K]: the 31x31 patch around the centre
    clamped 15 px inside the level, its intensity-centroid angle over the
    radius-15 disc, the pattern rotated to the nearest of 30 bins and
    rounded, bit = I(p1) < I(p2)."""
    dev, dt = blurred.device, blurred.dtype
    lh = torch.as_tensor([s[0] for s in shapes], device=dev)[level]
    lw = torch.as_tensor([s[1] for s in shapes], device=dev)[level]
    cy = torch.minimum(ky.clamp(min=HALF), lh - HALF - 1)
    cx = torch.minimum(kx.clamp(min=HALF), lw - HALF - 1)
    v = torch.arange(-HALF, HALF + 1, device=dev)
    patch = blurred[level[:, None, None], cy[:, None, None] + v[None, :, None],
                    cx[:, None, None] + v[None, None, :]]       # [K, 31, 31]
    umax = torch.floor(torch.sqrt(torch.clamp(
        torch.tensor(float(HALF * HALF)) - v.double() ** 2, min=0)) + 0.5)
    disc = (v[None, :].abs() <= umax[:, None].to(dev)).to(dt)   # [y, x]
    m10 = (patch * disc * v[None, :].to(dt)).sum((1, 2))
    m01 = (patch * disc * v[:, None].to(dt)).sum((1, 2))
    ang = torch.atan2(m01.float(), m10.float())
    q = torch.round(ang * (Q_BINS / (2 * np.pi))).long() % Q_BINS
    th = 2.0 * np.pi * q.double().cpu().numpy() / Q_BINS
    pat = brief_pattern().astype(np.float64)
    dy, dx = pat[None, ..., 0], pat[None, ..., 1]               # [1, 256, 2]
    ca, sa = np.cos(th)[:, None, None], np.sin(th)[:, None, None]
    rx = np.round(dx * ca - dy * sa).astype(np.int64)
    ry = np.round(dx * sa + dy * ca).astype(np.int64)
    lin = torch.as_tensor(np.clip(ry + HALF, 0, PATCH - 1) * PATCH +
                          np.clip(rx + HALF, 0, PATCH - 1), device=dev)
    s = torch.gather(patch.reshape(len(level), -1), 1,
                     lin.reshape(len(level), -1)).reshape(-1, N_BITS, 2)
    bits = (s[..., 1] - s[..., 0]) > 0
    return pack(bits), ang


def pack(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 32] u8, bit j of byte b = bit 8 b + j."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                     device=bits.device)
    return (bits.reshape(-1, 32, 8).to(torch.int32) * w).sum(-1).to(
        torch.uint8)


_POP = np.array([bin(i).count("1") for i in range(256)], np.int64)


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bits that differ between packed descriptors a, b [..., 32]."""
    return _POP[np.bitwise_xor(a, b)].sum(-1)


def level_coords(uv_raw: np.ndarray, octave: np.ndarray, scale: float):
    """The integer level coordinates a keypoint at raw level-0 position
    uv_raw [K, 2] on `octave` [K] may have come from: [K, 2, 2]
    candidates (x, y), the second differing only where the position lies
    within 0.05 px of a half pixel (a sub-pixel offset of +-0.5 rounds
    either way)."""
    p = uv_raw / (scale ** octave.astype(np.float64))[:, None]
    base = np.floor(p + 0.5)
    frac = p - np.floor(p)
    near = np.abs(frac - 0.5) < 0.05
    alt = np.where(near, np.where(p - base >= 0, base + 1, base - 1), base)
    return np.stack([base, alt], 1).astype(np.int64)


def descriptor_bits(img: np.ndarray, uv_raw: np.ndarray, octave: np.ndarray,
                    desc: np.ndarray, orb: dict, device="cpu",
                    dtype=torch.float32) -> Tuple[int, int]:
    """(bits that differ, bits compared) between the program's packed
    descriptors desc [K, 32] of one image img [H, W] and the reference's
    at the same keypoints (a keypoint with two candidate positions takes
    the nearer)."""
    if len(desc) == 0:
        return 0, 0
    blurred, shapes = blurred_levels(
        torch.as_tensor(np.asarray(img, np.float32), device=device),
        orb["n_levels"], orb["scale_factor"], orb["blur_ksize"],
        orb["blur_sigma"], dtype)
    cand = level_coords(uv_raw, octave, orb["scale_factor"])
    lv = torch.as_tensor(octave.astype(np.int64), device=device)
    best = None
    for c in range(2):
        ref, _ = steered_brief(
            blurred, shapes, lv,
            torch.as_tensor(cand[:, c, 0], device=device),
            torch.as_tensor(cand[:, c, 1], device=device))
        d = hamming(ref.cpu().numpy(), desc)
        best = d if best is None else np.minimum(best, d)
    return int(best.sum()), int(desc.shape[0] * N_BITS)


# ---------------------------------------------------------------------------
# place recognition
# ---------------------------------------------------------------------------

def bow_rows(vocab: Dict[str, np.ndarray], desc: Sequence[np.ndarray],
             width: int, dtype=torch.float64) -> list:
    """Each keyframe's L1-normalised TF-IDF row (DBoW2's transform) of its
    descriptor set desc[r] [n_r, 32] u8, as (words [m] int64 ascending,
    values [m] float64) over its nonzero words; the weights and the
    normalisation in `dtype`."""
    children = vocab["node_children"]
    cdesc = vocab["node_desc"]
    word_id = vocab["word_id"]
    weight = torch.as_tensor(vocab["word_weight"].astype(np.float64)
                             ).to(dtype)
    out = []
    for d in desc:
        node = np.zeros(len(d), np.int64)
        for _ in range(int(vocab["depth"]) if len(d) else 0):
            ch = children[node].astype(np.int64)                # [n, k]
            ok = ch >= 0
            dist = hamming(cdesc[np.maximum(ch, 0)], d[:, None, :])
            dist = np.where(ok, dist, 1 << 20)
            nxt = ch[np.arange(len(d)), np.argmin(dist, 1)]
            node = np.where(ok.any(1), nxt, node)
        words = word_id[node]
        words, count = np.unique(words[(words >= 0) & (words < width)],
                                 return_counts=True)
        row = torch.as_tensor(count).to(dtype) * weight[words]
        tot = row.abs().sum()
        if float(tot) > 0:
            row = row / tot
        vals = row.double().numpy()
        nz = vals != 0
        out.append((words[nz], vals[nz]))
    return out


def row_gap(a: tuple, b: tuple) -> float:
    """The widest gap between two sparse rows (words, values)."""
    words = np.union1d(a[0], b[0])
    va, vb = np.zeros(len(words)), np.zeros(len(words))
    va[np.searchsorted(words, a[0])] = a[1]
    vb[np.searchsorted(words, b[0])] = b[1]
    return float(np.abs(va - vb).max()) if len(words) else 0.0


def l1_score(a: tuple, b: tuple, dtype=None) -> Tuple[float, int]:
    """DBoW2's L1 score 1 - 0.5 |a - b|_1 of two sparse rows, and their
    shared words; with `dtype`, the values and the sums rounded to it."""
    words, ia, ib = np.intersect1d(a[0], b[0], assume_unique=True,
                                   return_indices=True)
    if dtype is None:
        low = np.minimum(a[1][ia], b[1][ib]).sum()
        return 1.0 - 0.5 * (np.abs(a[1]).sum() + np.abs(b[1]).sum()
                            - 2.0 * low), len(words)
    t = lambda x: torch.as_tensor(x).to(dtype)
    low = torch.minimum(t(a[1][ia]), t(b[1][ib])).sum()
    l1 = t(a[1]).abs().sum() + t(b[1]).abs().sum() - 2 * low
    return float(t(1.0) - t(0.5) * l1), len(words)


def loop_candidates(rows: list, valid: np.ndarray, covis: np.ndarray,
                    query: int, n_out: int = 8, shared_frac: float = 0.8,
                    acc_frac: float = 0.75, min_w: int = 15,
                    n_neighbours: int = 30, dtype=None) -> dict:
    """ORB-SLAM2's loop candidates for keyframe `query` (LoopClosing.cc
    DetectLoop's minScore over the query's best 30 covisible keyframes of
    weight >= 15, then KeyFrameDatabase.cc DetectLoopCandidates) over the
    sparse rows [K] (None: no keyframe) with valid [K] and the covisibility
    weights covis [K, K], in float64 (with `dtype`, the scores in it).
    Returns {id: accumulated group score} of the kept candidates and
    `margin`, the least distance of a score from a threshold or tie it
    was decided against (a decision inside round-off of the program's
    float32 may fall either way)."""
    K = len(valid)
    scores = np.full(K, 0.5)
    sw = np.zeros(K, np.int64)
    for k in np.nonzero(valid)[0]:
        scores[k], sw[k] = l1_score(rows[query], rows[k], dtype)
    w_q = np.where(valid, covis[query], 0)
    nb = np.argsort(-w_q, kind="stable")[:n_neighbours]
    nb = nb[w_q[nb] >= min_w]
    min_score = scores[nb].min() if len(nb) else 1.0
    ok = valid & (np.arange(K) != query) & ~(covis[query] >= min_w)
    sw = np.where(ok, sw, 0)
    gate = ok & (sw > int(np.float32(shared_frac) * np.float32(sw.max())))
    gate &= sw > 0
    margins = [np.abs(scores[gate] - min_score)]
    cand = gate & (scores >= min_score)
    if not cand.any():
        return {"ids": {}, "margin": _least(margins)}
    w = np.where(valid[None] & valid[:, None], covis, 0)
    top_idx = np.argsort(-w, axis=1, kind="stable")[:, :10]
    top_w = np.take_along_axis(w, top_idx, 1)
    member = cand[top_idx] & (top_w > 0)
    acc = np.where(cand, scores, 0.0) + np.where(member, scores[top_idx],
                                                 0.0).sum(1)
    mval = np.where(member, scores[top_idx], -np.inf)
    acc = np.where(cand, acc, -np.inf)
    cut = acc_frac * acc.max()
    margins.append(np.abs(acc[cand] - cut))
    keep = acc > cut
    # each kept group elects its best-scoring member (itself on a tie)
    srt = -np.sort(-mval[keep], axis=1)
    self_s = scores[keep]
    has = np.isfinite(srt[:, 0])
    margins.append(np.abs(srt[has, 0] - self_s[has]))
    two = np.isfinite(srt[:, 1])
    margins.append(srt[two, 0] - srt[two, 1])
    marg = top_idx[np.arange(K), mval.argmax(1)]
    best = np.where(mval.max(1) > np.where(cand, scores, -np.inf), marg,
                    np.arange(K))
    seen = {}
    for r, s in zip(best[keep], acc[keep]):
        seen[int(r)] = max(seen.get(int(r), -np.inf), float(s))
    order = sorted(seen, key=lambda r: (-seen[r], r))
    if len(order) > n_out:
        margins.append(np.array([seen[order[n_out - 1]] -
                                 seen[order[n_out]]]))
    return {"ids": {r: seen[r] for r in order[:n_out]},
            "margin": _least(margins)}


def _least(arrays) -> float:
    vals = [float(a.min()) for a in arrays if len(a)]
    return min(vals) if vals else float("inf")


# ---------------------------------------------------------------------------
# tracking and mapping
# ---------------------------------------------------------------------------

def umeyama(src: np.ndarray, dst: np.ndarray):
    """Rotation R and translation t (float64) minimising |R src + t - dst|
    over the rows of src, dst [n, 3]."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate(est: np.ndarray, gt: np.ndarray):
    """(RMSE m, R, t) of estimated positions est [n, 3] against gt [n, 3]
    after the rigid alignment of est onto gt."""
    R, t = umeyama(est.astype(np.float64), gt.astype(np.float64))
    err = est @ R.T + t - gt
    return float(np.sqrt((err ** 2).sum(1).mean())), R, t


def plane_distances(points: np.ndarray, planes,
                    extents=None) -> np.ndarray:
    """Each world point's distance [n] to the nearest plane of the room
    (planes: (point, normal, u axis, v axis) tuples; `extents`: each
    plane's (half_u, half_v) about its point, None for an infinite one)."""
    d = []
    for (p0, n, ua, va), ext in zip(planes, extents or [None] * len(planes)):
        x = points - p0
        e = np.abs(x @ n)
        if ext is not None:
            du = np.maximum(np.abs(x @ ua) - ext[0], 0)
            dv = np.maximum(np.abs(x @ va) - ext[1], 0)
            e = np.sqrt(e * e + du * du + dv * dv)
        d.append(e)
    return np.stack(d, 1).min(1)
