"""Atlas-formulated ORB extraction (port of orb_slam2_tpu/frontend/atlas.py,
`build_atlas_extractor` with one image).

Every stage after the pyramid works on a zero-padded level atlas
[L, Hp, Wp] (Hp, Wp = level-0 size):

  pyramid (cascade resize)   -> JAX's antialiased bilinear weights, 2 matmuls
  FAST-9 + 3x3 NMS           -> the CUDA kernel, once per level (fast_cuda)
  dual-threshold 30 px cells -> one reshape/tile max over the score atlas
  spatial selection          -> fine-tile top-2 + coarse-winner bonus + one
                                top-k per level
  blur                       -> separable shift-accumulate over the atlas
  descriptors                -> one gather of all 31x31 patches + ONE matmul
                                computing every orientation bin's BRIEF
                                differences and the IC-angle moments

`lax.top_k` breaks ties towards the lower index; `torch.topk` promises no
order on ties, so every top-k here is a stable descending sort.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_tpu_torch.config import ORBConfig
from orb_slam2_tpu_torch.frontend import orb, pyramid
from orb_slam2_tpu_torch.frontend.extractor import Features, per_level_quota
from orb_slam2_tpu_torch.frontend.fast_cuda import fast_nms_raw
from orb_slam2_tpu_torch.map.state import stable_topk

FINE_TILE = 8       # fine selection tile (px, level coords): top-2 winners
COARSE = 2          # coarse cell = COARSE x COARSE fine tiles (bonus winners)
Q_BINS = 30         # steered-BRIEF orientation bins


def _brief_moment_matrix(Q: int) -> np.ndarray:
    """[961, Q*256 + 2] matrix computing, from a flat 31x31 patch, the BRIEF
    pair differences I(p2)-I(p1) for every orientation bin (bit = diff > 0)
    plus the IC-angle moments m10, m01 in the last two columns."""
    pat = orb.PATTERN.astype(np.float32)                 # [256, 2, (dy, dx)]
    D = np.zeros((orb.PATCH * orb.PATCH, Q * orb.N_BITS + 2), np.float32)
    for q in range(Q):
        th = 2.0 * np.pi * q / Q
        ca, sa = np.cos(th), np.sin(th)
        dy, dx = pat[..., 0], pat[..., 1]
        rx = np.round(dx * ca - dy * sa).astype(np.int64)
        ry = np.round(dx * sa + dy * ca).astype(np.int64)
        iy = np.clip(ry + orb.HALF, 0, orb.PATCH - 1)
        ix = np.clip(rx + orb.HALF, 0, orb.PATCH - 1)
        lin = iy * orb.PATCH + ix                        # [256, 2]
        cols = q * orb.N_BITS + np.arange(orb.N_BITS)
        np.add.at(D, (lin[:, 1], cols), 1.0)
        np.add.at(D, (lin[:, 0], cols), -1.0)
    D[:, -2] = (orb._MASK * orb._XX).reshape(-1)
    D[:, -1] = (orb._MASK * orb._YY).reshape(-1)
    return D


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _slice_gather(flat: torch.Tensor, r0, c0, rows: int, cols: int):
    """[K, rows, cols] windows of `flat` [R, C] starting at (r0, c0) [K],
    starts clamped so each window lies inside (lax.gather's rule)."""
    R, C = flat.shape
    r0 = torch.clamp(r0, 0, R - rows)
    c0 = torch.clamp(c0, 0, C - cols)
    ar = torch.arange(rows, device=flat.device)
    ac = torch.arange(cols, device=flat.device)
    return flat[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ac)[:, None, :]]


def _para(l, c, r):
    den = l - 2.0 * c + r
    return torch.where(torch.abs(den) > 1e-6,
                       torch.clamp(0.5 * (l - r) / den, -0.5, 0.5),
                       torch.zeros_like(den))


def build_atlas_extractor(cfg: ORBConfig, height: int, width: int,
                          device=None):
    """Return `extract(img [H, W] f32) -> Features` (cap slots)."""
    L = cfg.n_levels
    quotas = per_level_quota(cfg.n_features, L, cfg.scale_factor)
    shapes = pyramid.level_shapes(height, width, L, cfg.scale_factor)
    maxq = max(quotas)
    cap = cfg.max_keypoints
    if sum(quotas) > cap:
        raise ValueError(f"max_keypoints {cap} < quota sum {sum(quotas)}")
    Hp, Wp = height, width
    border = cfg.edge_threshold - 3
    dev = torch.device(device) if device is not None else None
    tens = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    lvl_h = tens([s[0] for s in shapes], torch.int64)
    lvl_w = tens([s[1] for s in shapes], torch.int64)
    scale_pow = tens([cfg.scale_factor ** i for i in range(L)], torch.float32)
    quota_t = tens(quotas, torch.int64)
    # cascade resize weights: level i-1 -> level i, per axis (None = same)
    rs_w = []
    for i in range(1, L):
        (h0, w0), (h1, w1) = shapes[i - 1], shapes[i]
        rs_w.append((tens(pyramid.resize_weights(h0, h1), torch.float32)
                     if h0 != h1 else None,
                     tens(pyramid.resize_weights(w0, w1), torch.float32)
                     if w0 != w1 else None))

    cell = cfg.cell_size
    Hc, Wc = _ceil_to(Hp, cell), _ceil_to(Wp, cell)
    gy_c, gx_c = Hc // cell, Wc // cell
    ft = FINE_TILE
    Hf, Wf = _ceil_to(Hp, ft * COARSE), _ceil_to(Wp, ft * COARSE)
    gy_f, gx_f = Hf // ft, Wf // ft
    n_fine = gy_f * gx_f
    KL = L * maxq

    blur_w = [float(v) for v in
              pyramid._gauss_kernel1d(cfg.blur_ksize, cfg.blur_sigma)]
    brief_mat = tens(_brief_moment_matrix(Q_BINS), torch.float32)
    lvl_of = torch.arange(L, device=dev).repeat_interleave(maxq)   # [KL]
    ys = torch.arange(Hp, device=dev)[None, :, None]
    xs = torch.arange(Wp, device=dev)[None, None, :]
    inside = ((ys >= border) & (ys < (lvl_h[:, None, None] - border)) &
              (xs >= border) & (xs < (lvl_w[:, None, None] - border)))

    def blur_atlas(atlas):
        """Separable Gaussian as shift-accumulates over [L, Hp, Wp]; the
        wrap pollutes only a band far from any selectable keypoint."""
        r = cfg.blur_ksize // 2
        rows = None
        for i, w in enumerate(blur_w):
            t = torch.roll(atlas, i - r, 1) * w
            rows = t if rows is None else rows + t
        out = None
        for i, w in enumerate(blur_w):
            t = torch.roll(rows, i - r, 2) * w
            out = t if out is None else out + t
        return out

    def extract(img: torch.Tensor) -> Features:
        # ---- pyramid (cascade, like ORBextractor.cc:1107) ----
        levels = [img]
        for wh, ww in rs_w:
            x = levels[-1]
            if wh is not None:
                x = wh.T @ x
            if ww is not None:
                x = x @ ww
            levels.append(x)
        pad = lambda a: F.pad(a, (0, Wp - a.shape[-1], 0, Hp - a.shape[-2]))
        atlas = torch.stack([pad(lv) for lv in levels])          # [L, Hp, Wp]

        # ---- FAST-9 + NMS per level (the CUDA kernel on the card) ----
        smaps, raws = [], []
        for lv in levels:
            s, r = fast_nms_raw(lv)
            smaps.append(pad(s))
            raws.append(pad(r))
        score = torch.stack(smaps)
        raw = torch.stack(raws)
        zero = torch.zeros((), dtype=score.dtype, device=score.device)

        # ---- dual-threshold 30 px cells (ORBextractor.cc:809-816) ----
        sc = F.pad(score, (0, Wc - Wp, 0, Hc - Hp))
        cmax = sc.reshape(L, gy_c, cell, gx_c, cell).amax((2, 4))
        th = torch.where(cmax > float(cfg.ini_th_fast),
                         float(cfg.ini_th_fast), float(cfg.min_th_fast))
        th_full = th[:, :, None, :, None].expand(
            L, gy_c, cell, gx_c, cell).reshape(L, Hc, Wc)[:, :Hp, :Wp]
        score = torch.where(score > th_full, score, zero)
        score = torch.where(inside, score, zero)

        # ---- spatial selection: fine-tile top-2 + coarse-winner bonus ----
        sf_ = F.pad(score, (0, Wf - Wp, 0, Hf - Hp))
        tiles = sf_.reshape(L, gy_f, ft, gx_f, ft).permute(0, 1, 3, 2, 4)
        tiles = tiles.reshape(L, gy_f, gx_f, ft * ft)
        v2, l2 = stable_topk(tiles, 2)                       # [L, gyf, gxf, 2]
        wval, wloc = v2[..., 0], l2[..., 0]
        cmax2 = wval.reshape(L, gy_f // COARSE, COARSE,
                             gx_f // COARSE, COARSE).amax((2, 4))
        cmax2 = cmax2.repeat_interleave(COARSE, 1).repeat_interleave(COARSE, 2)
        is_cw = (wval >= cmax2) & (wval > 0)
        prio1 = torch.where(wval > 0, wval + is_cw.to(torch.float32) * 1e6,
                            -1.0)
        prio2 = torch.where(v2[..., 1] > 0, v2[..., 1], -1.0)
        prio = torch.stack([prio1.reshape(L, n_fine),
                            prio2.reshape(L, n_fine)], 1).reshape(L, 2 * n_fine)
        locs = torch.stack([wloc.reshape(L, n_fine),
                            l2[..., 1].reshape(L, n_fine)], 1
                           ).reshape(L, 2 * n_fine)
        vals = torch.stack([wval.reshape(L, n_fine),
                            v2[..., 1].reshape(L, n_fine)], 1
                           ).reshape(L, 2 * n_fine)
        if 2 * n_fine < maxq:
            prio = F.pad(prio, (0, maxq - 2 * n_fine), value=-1.0)
        topv, topi = stable_topk(prio, maxq)                 # [L, maxq]
        topi = torch.clamp(topi, max=2 * n_fine - 1)
        sel_valid = (topv > 0) & (
            torch.arange(maxq, device=dev)[None, :] < quota_t[:, None])
        fcell = topi % n_fine
        cy, cx = fcell // gx_f, fcell % gx_f
        loc = torch.gather(locs, 1, topi)
        y = cy * ft + loc // ft
        x = cx * ft + loc % ft
        resp = torch.gather(vals, 1, topi)

        # ---- compact [L*maxq] -> [cap] (level-major order) ----
        y, x, resp, sel_valid = (a.reshape(KL) for a in (y, x, resp, sel_valid))
        order = torch.where(sel_valid,
                            float(KL) - torch.arange(KL, device=dev).float(),
                            -1.0)
        if KL < cap:
            order = F.pad(order, (0, cap - KL), value=-1.0)
        ov, ci = stable_topk(order, cap)
        ci = torch.clamp(ci, max=KL - 1)
        ky, kx = y[ci], x[ci]
        kv = sel_valid[ci] & (ov > 0)
        kl = lvl_of[ci]
        kr = torch.where(kv, resp[ci], zero)

        # ---- subpixel corner: 3x3 parabola on the raw (pre-NMS) score ----
        nb = _slice_gather(raw.reshape(L * Hp, Wp), kl * Hp + ky - 1, kx - 1,
                           3, 3)
        sub_dx = _para(nb[:, 1, 0], nb[:, 1, 1], nb[:, 1, 2])
        sub_dy = _para(nb[:, 0, 1], nb[:, 1, 1], nb[:, 2, 1])

        # ---- descriptors: one batched stage over all keypoints ----
        blurred = blur_atlas(atlas)
        cyk = torch.minimum(torch.clamp(ky, min=orb.HALF),
                            lvl_h[kl] - orb.HALF - 1)
        cxk = torch.minimum(torch.clamp(kx, min=orb.HALF),
                            lvl_w[kl] - orb.HALF - 1)
        P = orb.PATCH
        patches = _slice_gather(blurred.reshape(L * Hp, Wp),
                                kl * Hp + cyk - orb.HALF, cxk - orb.HALF, P, P)
        allq = patches.reshape(cap, P * P) @ brief_mat       # [K, Q*256 + 2]
        ang = torch.atan2(allq[:, -1], allq[:, -2])
        qbin = torch.round(ang * (Q_BINS / (2.0 * np.pi))).to(torch.int64) \
            % Q_BINS
        diffs = torch.gather(
            allq[:, :Q_BINS * orb.N_BITS].reshape(cap, Q_BINS, orb.N_BITS), 1,
            qbin[:, None, None].expand(cap, 1, orb.N_BITS))[:, 0]
        desc = orb.pack_bits(diffs > 0)

        scale = scale_pow[kl]
        uv = torch.stack([(kx.to(torch.float32) + sub_dx) * scale,
                          (ky.to(torch.float32) + sub_dy) * scale], -1)
        return Features(uv=uv, response=kr, octave=kl.to(torch.int32),
                        angle=ang, desc=desc, valid=kv)

    return extract
