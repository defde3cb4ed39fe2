"""Fused FAST-9 score + 3x3 NMS: the CUDA kernel's wrapper and its plain
PyTorch version.

`fast_nms_raw(img)` returns `(nms, raw)` for one [H, W] f32 pyramid level.
For a CUDA tensor it launches the hand-written kernel in csrc/fast_nms.cu
(built with nvcc for sm_90a into `_build/` at first use and loaded with
ctypes); for a CPU tensor it runs `fast_nms_raw_plain`, the same function in
tensor ops.  There is no fallback from one to the other: a CUDA tensor that
the kernel cannot take raises.

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.frontend import fast

SOURCE = cuda_build.source("fast_nms.cu")

launches = 0
_lib = None


def fast_nms_raw_plain(img: torch.Tensor):
    """(nms, raw) in tensor ops: `nms3x3(fast_score_map(img))`."""
    raw = fast.fast_score_map(img)
    return fast.nms3x3(raw), raw


def build(verbose: bool = False) -> str:
    """Compile csrc/fast_nms.cu (once per source content); its path."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.fast_nms_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.fast_nms_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fast_nms_cuda(img: torch.Tensor):
    """Launch the kernel on a CUDA [H, W] f32 tensor; returns (nms, raw)."""
    global launches
    if img.dim() != 2 or img.dtype != torch.float32 or not img.is_cuda:
        raise ValueError(f"expected a CUDA [H, W] float32 tensor, got "
                         f"{tuple(img.shape)} {img.dtype} on {img.device}")
    H, W = img.shape
    if H < 7 or W < 7:
        raise ValueError(f"level {H}x{W} is smaller than the FAST footprint")
    img = img.contiguous()
    nms = torch.empty_like(img)
    raw = torch.empty_like(img)
    lib = _load()
    with torch.cuda.device(img.device):
        err = lib.fast_nms_launch(img.data_ptr(), nms.data_ptr(),
                                  raw.data_ptr(), H, W,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    launches += 1
    return nms, raw


def fast_nms_raw(img: torch.Tensor):
    """[H, W] f32 level -> (nms score, raw score).  CUDA tensors go through
    the kernel; CPU tensors through the plain version."""
    if img.is_cuda:
        return fast_nms_cuda(img)
    return fast_nms_raw_plain(img)
