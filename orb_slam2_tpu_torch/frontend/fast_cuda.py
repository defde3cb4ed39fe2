"""Fused FAST-9 score + 3x3 NMS over a whole level atlas: the CUDA kernel's
wrapper and its plain PyTorch version.

`fast_nms_atlas(atlas, shapes)` returns `(nms, raw)`, both [G, Hp, Wp] f32,
for a zero-padded level atlas [G, Hp, Wp] (G = n_images * L, image-major)
whose plane g holds level g % L, of shape `shapes[g % L]`, in its top-left
corner; both maps are zero outside each level.  For a CUDA tensor it makes
ONE launch of the hand-written kernel in csrc/fast_nms.cu (built with nvcc
for sm_90a into `_build/` at first use and loaded with ctypes) for all
levels of all images; for a CPU tensor it runs `fast_nms_atlas_plain`, the
same function in tensor ops.  There is no fallback from one to the other:
a CUDA tensor that the kernel cannot take raises.

`fast_nms_raw(img)` / `fast_nms(img)` are the single-image entry points
(the counterparts of `fast_nms_raw_pallas` / `fast_nms_pallas`) that the
per-level extractor calls once per level: an [H, W] f32 level in, [H, W]
maps out; on a CUDA tensor one launch of the same kernel over a one-plane
atlas, on a CPU tensor `fast_nms_raw_plain`.

`device_counts()` reads the launches and the planes they covered as the
kernel itself counts them on the device (one thread of each launch adds),
so a replayed CUDA graph counts too; `reset_device_counts()` zeroes them.
A call on a CPU tensor counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.core import control
from orb_slam2_tpu_torch.frontend import fast

SOURCE = cuda_build.source("fast_nms.cu")

_lib = None
_counts = {}        # device -> int32 [2]: launches, planes


def _count_buffer(dev: torch.device) -> torch.Tensor:
    t = _counts.get(dev)
    if t is None:
        t = _counts[dev] = control.register(
            torch.zeros(2, dtype=torch.int32, device=dev))
    return t


def device_counts():
    """(launches, planes) counted by the kernel on every device."""
    tot = [0, 0]
    for t in _counts.values():
        a, b = t.tolist()
        tot[0] += a
        tot[1] += b
    return tuple(tot)


def reset_device_counts():
    for t in _counts.values():
        t.zero_()


def fast_nms_raw_plain(img: torch.Tensor):
    """(nms, raw) of one [H, W] level in tensor ops:
    `nms3x3(fast_score_map(img))`."""
    raw = fast.fast_score_map(img)
    return fast.nms3x3(raw), raw


def fast_nms_atlas_plain(atlas: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]]):
    """`fast_nms_atlas` in tensor ops: `fast_nms_raw_plain` on each level's
    crop, zero-padded to the atlas plane."""
    _check(atlas, shapes)
    nms, raw = torch.zeros_like(atlas), torch.zeros_like(atlas)
    for g in range(atlas.shape[0]):
        h, w = shapes[g % len(shapes)]
        nms[g, :h, :w], raw[g, :h, :w] = fast_nms_raw_plain(atlas[g, :h, :w])
    return nms, raw


def _check(atlas: torch.Tensor, shapes):
    if atlas.dim() != 3 or atlas.dtype != torch.float32:
        raise ValueError(f"expected a [G, Hp, Wp] float32 atlas, got "
                         f"{tuple(atlas.shape)} {atlas.dtype}")
    G, Hp, Wp = atlas.shape
    L = len(shapes)
    if L < 1 or G % L != 0:
        raise ValueError(f"{G} atlas planes are not a multiple of {L} levels")
    for h, w in shapes:
        if not (1 <= h <= Hp and 1 <= w <= Wp):
            raise ValueError(f"level {h}x{w} does not fit the {Hp}x{Wp} "
                             "atlas plane")


def build(verbose: bool = False) -> str:
    """Compile csrc/fast_nms.cu (once per source content); its path."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fast_nms_atlas_launch.argtypes = [p, p, p, ctypes.POINTER(i), i,
                                              i, i, i, p, p]
        lib.fast_nms_atlas_launch.restype = ctypes.c_int
        lib.fast_nms_max_levels.argtypes = []
        lib.fast_nms_max_levels.restype = ctypes.c_int
        lib.max_levels = lib.fast_nms_max_levels()
        _lib = lib
    return _lib


def fast_nms_atlas_cuda(atlas: torch.Tensor,
                        shapes: Sequence[Tuple[int, int]]):
    """One kernel launch over a CUDA [G, Hp, Wp] f32 atlas; (nms, raw)."""
    if not atlas.is_cuda:
        raise ValueError(f"expected a CUDA atlas, got one on {atlas.device}")
    _check(atlas, shapes)
    G, Hp, Wp = atlas.shape
    L = len(shapes)
    lib = _load()
    if L > lib.max_levels:
        raise ValueError(f"{L} levels > the kernel's {lib.max_levels}")
    hw = (ctypes.c_int * (2 * L))(*[h for h, _ in shapes],
                                  *[w for _, w in shapes])
    atlas = atlas if atlas.is_contiguous() else atlas.contiguous()
    nms, raw = torch.empty_like(atlas), torch.empty_like(atlas)
    count = _count_buffer(atlas.device)
    err = cuda_build.launch(atlas.device, lib.fast_nms_atlas_launch,
                            atlas.data_ptr(), nms.data_ptr(), raw.data_ptr(),
                            hw, L, G, Hp, Wp, count.data_ptr())
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    return nms, raw


def fast_nms_atlas(atlas: torch.Tensor, shapes: Sequence[Tuple[int, int]]):
    """[G, Hp, Wp] f32 level atlas -> (nms score, raw score), each
    [G, Hp, Wp].  CUDA tensors go through the kernel (one launch); CPU
    tensors through the plain version."""
    if atlas.is_cuda:
        return fast_nms_atlas_cuda(atlas, shapes)
    return fast_nms_atlas_plain(atlas, shapes)


def fast_nms_raw(img: torch.Tensor):
    """[H, W] f32 level -> (nms score, raw score), each [H, W].  A CUDA
    tensor goes through the kernel (one launch, a one-plane atlas); a CPU
    tensor through the plain version."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"expected an [H, W] float32 level, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if img.is_cuda:
        nms, raw = fast_nms_atlas_cuda(img[None], [tuple(img.shape)])
        return nms[0], raw[0]
    return fast_nms_raw_plain(img)


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """[H, W] f32 level -> [H, W] FAST-9 score after 3x3 NMS
    (`fast_nms_raw`'s first map)."""
    return fast_nms_raw(img)[0]
