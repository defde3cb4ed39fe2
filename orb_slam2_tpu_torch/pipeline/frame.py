"""Frame construction: features + keypoint undistortion, and the depth of
each keypoint for RGB-D (sampled from the depth map) and stereo (left/right
matching with SAD refinement) (port of orb_slam2_tpu/pipeline/frame.py;
reference Frame.cc:61-228, 466-664).

The stereo path extracts both images in one batched atlas program (one
FAST launch for all 2·L planes) and refines each match on the keypoint's
own pyramid level of that atlas.  Its SAD stage stays in tensor ops: one
[N, 11, 11] window gather, one [N, 11, 21] band gather, eleven SADs as one
reduction.  The RGB-D function batches the images of S sequences the same
way (`n_images = S`, distributed/dp.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.config import SLAMConfig
from orb_slam2_tpu_torch.core import camera
from orb_slam2_tpu_torch.frontend import pyramid
from orb_slam2_tpu_torch.frontend.atlas import _slice_gather
from orb_slam2_tpu_torch.frontend.extractor import Features, build_extractor
from orb_slam2_tpu_torch.matching import hamming, search


class Frame(NamedTuple):
    uv: torch.Tensor        # [N, 2] undistorted keypoint coords
    uv_raw: torch.Tensor    # [N, 2] raw coords
    ur: torch.Tensor        # [N] stereo/virtual right u (-1 = none)
    depth: torch.Tensor     # [N] depth (-1 = none)
    octave: torch.Tensor    # [N] i32
    angle: torch.Tensor     # [N]
    desc: torch.Tensor      # [N, 32] u8
    valid: torch.Tensor     # [N] bool
    frame_id: torch.Tensor  # i32
    timestamp: torch.Tensor  # f32

    @property
    def n(self):
        """Valid keypoints (per frame of a stacked Frame)."""
        return torch.sum(self.valid.to(torch.int32), dim=-1)


def _finish(cfg: SLAMConfig, feats: Features, ur, depth, frame_id, timestamp):
    dev = feats.uv.device
    K = camera.intrinsics(cfg.camera, dev)
    d = camera.distortion(cfg.camera, dev)
    uv = camera.undistort_points(K, d, feats.uv)
    return Frame(uv=uv, uv_raw=feats.uv, ur=ur, depth=depth,
                 octave=feats.octave, angle=feats.angle, desc=feats.desc,
                 valid=feats.valid,
                 frame_id=torch.as_tensor(frame_id, dtype=torch.int32,
                                          device=dev),
                 timestamp=torch.as_tensor(timestamp, dtype=torch.float32,
                                           device=dev))


def build_mono_frame_fn(cfg: SLAMConfig, device=None):
    """Returns (image [H, W] f32, frame_id, timestamp) -> Frame, its
    extractor on `device`: CUDA unless the caller names one."""
    extract = build_extractor(cfg.orb, cfg.camera.height, cfg.camera.width,
                              device=device)

    def fn(img, frame_id, timestamp):
        feats = extract(img)
        n = feats.uv.shape[0]
        none = torch.full((n,), -1.0, device=img.device)
        return _finish(cfg, feats, none, none.clone(), frame_id, timestamp)

    return fn


def build_rgbd_frame_fn(cfg: SLAMConfig, device=None, n_images: int = 1):
    """Returns (image [H, W], depth map [H, W] in metres, frame_id,
    timestamp) -> Frame: the registered depth sampled at each keypoint and
    the virtual right coordinate from the undistorted u (reference
    Frame.cc:643-664).

    With `n_images = S` it takes S images and depth maps ([S, H, W]) and
    S frame ids and timestamps, extracts all of them in one batched atlas
    program (one FAST launch over S·L planes), and returns one Frame whose
    fields carry a leading S axis; per image, the same Frame as the
    one-image function's, bit for bit on the card too (the BRIEF GEMM runs
    once an image: `build_atlas_extractor`'s `frames`)."""
    extract = build_extractor(cfg.orb, cfg.camera.height, cfg.camera.width,
                              device=device, n_images=n_images,
                              frames=n_images)
    bf = cfg.camera.bf

    def fn(img, depth_map, frame_id, timestamp):
        feats = extract(img)
        dev = img.device
        H, W = depth_map.shape[-2:]
        xi = torch.clamp(torch.round(feats.uv[..., 0]).long(), 0, W - 1)
        yi = torch.clamp(torch.round(feats.uv[..., 1]).long(), 0, H - 1)
        if n_images == 1:
            d = depth_map[yi, xi]
        else:
            d = depth_map[torch.arange(n_images, device=dev)[:, None], yi, xi]
        has = (d > 0) & feats.valid
        K = camera.intrinsics(cfg.camera, dev)
        uv_und = camera.undistort_points(K, camera.distortion(cfg.camera, dev),
                                         feats.uv)
        ur = torch.where(has, camera.stereo_right_u(K, bf, uv_und, d), -1.0)
        depth = torch.where(has, d, -1.0)
        return _finish(cfg, feats, ur, depth, frame_id, timestamp)

    return fn


def _sad_subpixel_atlas(atlas, lvl_h, lvl_w, n_levels, uv_l, ur0, octave,
                        matched, scale_factors, w: int = 5, slide: int = 5):
    """Sliding SAD + parabola subpixel fit on the keypoint's own pyramid
    level (reference Frame::ComputeStereoMatches, Frame.cc:552-608).

    atlas: [2*L, Hp, Wp] raw padded level stack (left levels, then right).
    One [11, 11] slice gather fetches each left window and one [11, 21]
    slice gather its right candidate band; the 11 displaced windows are
    views of the band.  Returns (ur refined, level-0 coords [N], best SAD
    [N], inf where unmatched)."""
    G, Hp, Wp = atlas.shape
    L = n_levels
    o = octave.long()
    s = scale_factors[o]                                     # [N]
    # integer level coordinates (round half to even, as jnp.round)
    xl = torch.round(uv_l[:, 0] / s).long()
    yl = torch.round(uv_l[:, 1] / s).long()
    xr_i = torch.round(ur0 / s).long()
    hs, ws = lvl_h[o], lvl_w[o]
    clip = lambda v, lo, hi: torch.minimum(torch.clamp(v, min=lo), hi)
    yl = clip(yl, w, hs - w - 1)
    xl = clip(xl, w, ws - w - 1)
    xr_i = clip(xr_i, w + slide, ws - w - slide - 1)

    flat = atlas.reshape(G * Hp, Wp)
    W2 = 2 * w + 1
    wl = _slice_gather(flat, o * Hp + yl - w, xl - w, W2, W2)   # [N, 11, 11]
    band = _slice_gather(flat, (o + L) * Hp + yl - w, xr_i - w - slide, W2,
                         W2 + 2 * slide)                         # [N, 11, 21]
    wl = wl - wl[:, w:w + 1, w:w + 1]               # centre-normalise (:557)
    wr = band.unfold(2, W2, 1).transpose(1, 2)       # [N, 11 shifts, 11, 11]
    wr = wr - wr[:, :, w:w + 1, w:w + 1]
    sads = torch.sum(torch.abs(wl[:, None] - wr), dim=(2, 3))    # [N, 11]
    best = torch.argmin(sads, dim=1)                  # the first minimum
    interior = (best > 0) & (best < 2 * slide)
    bi = torch.clamp(best, 1, 2 * slide - 1)
    near = torch.gather(sads, 1, torch.stack([bi - 1, bi, bi + 1], 1))
    sm1, s0, sp1 = near[:, 0], near[:, 1], near[:, 2]
    denom = sm1 - 2.0 * s0 + sp1
    delta = 0.5 * (sm1 - sp1) / torch.where(torch.abs(denom) > 1e-6, denom,
                                            1e-6)
    delta = torch.clamp(delta, -1.0, 1.0)
    xr_ref = (xr_i.to(torch.float32) + (bi.to(torch.float32) - slide) +
              delta) * s
    ur_ref = torch.where(matched & interior, xr_ref, ur0)
    return ur_ref, torch.where(matched, s0, float("inf"))


def build_stereo_frame_fn(cfg: SLAMConfig, device=None):
    """Returns (left [H, W], right [H, W], frame_id, timestamp) -> Frame.

    Both images go through one batched extraction; each left keypoint takes
    the best right candidate (Hamming <= th_high) within its row band
    (|vL - vR| <= 2 x its octave's scale), the disparity range and +-1
    octave; the disparity is refined by a +-5 sliding SAD and a parabola,
    and matches above 1.5 x 1.4 x the median SAD are dropped (reference
    Frame::ComputeStereoMatches, Frame.cc:466-640)."""
    dev = resolve_device(device)
    H, W = cfg.camera.height, cfg.camera.width
    extract2 = build_extractor(cfg.orb, H, W, device=dev, n_images=2,
                               return_atlas=True)
    bf = cfg.camera.bf
    L = cfg.orb.n_levels
    scale_factors = torch.tensor(cfg.orb.scale_factors, dtype=torch.float32,
                                 device=dev)
    shapes = pyramid.level_shapes(H, W, L, cfg.orb.scale_factor)
    lvl_h = torch.tensor([h for h, _ in shapes], device=dev)
    lvl_w = torch.tensor([w for _, w in shapes], device=dev)
    max_d = bf / max(cfg.camera.baseline, 1e-6)

    def fn(img_l, img_r, frame_id, timestamp):
        both, atlas = extract2(torch.stack([img_l, img_r]))
        fl = Features(*(a[0] for a in both))
        fr = Features(*(a[1] for a in both))
        # row band |vL - vR| <= 2 x scale of the left octave (:475-493)
        r_l = scale_factors[fl.octave.long()]
        dv = torch.abs(fl.uv[:, None, 1] - fr.uv[None, :, 1])
        band = dv <= 2.0 * r_l[:, None]
        # disparity in [0.1, bf / baseline] (:495-498)
        disp = fl.uv[:, None, 0] - fr.uv[None, :, 0]
        drange = (disp >= 0.1) & (disp <= max_d)
        oct_ok = torch.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1
        dist = hamming.hamming_matrix(fl.desc, fr.desc)
        res = search.match_descriptors(
            dist, band & drange & oct_ok, max_dist=cfg.match.th_high,
            ratio=None, valid_a=fl.valid, valid_b=fr.valid)
        matched = res.idx >= 0
        ur0 = torch.where(matched, fr.uv[res.idx.long().clamp(min=0), 0],
                          -1.0)
        ur, sad = _sad_subpixel_atlas(atlas, lvl_h, lvl_w, L, fl.uv, ur0,
                                      fl.octave, matched, scale_factors)
        # median-SAD outlier cut (:626-639)
        n = fl.uv.shape[0]
        n_m = torch.clamp(torch.sum(matched.to(torch.int32)), min=1)
        sad_sorted = torch.sort(torch.where(matched, sad, float("inf")))[0]
        med = sad_sorted[torch.clamp((n_m - 1) // 2, 0, n - 1).reshape(1)][0]
        keep = matched & (sad <= 1.5 * 1.4 * med)
        disp_m = torch.clamp(fl.uv[:, 0] - ur, 0.01, max_d)
        depth = torch.where(keep, bf / disp_m, -1.0)
        return _finish(cfg, fl, torch.where(keep, ur, -1.0), depth, frame_id,
                       timestamp)

    return fn
