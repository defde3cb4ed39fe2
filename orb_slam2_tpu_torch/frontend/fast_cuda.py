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
import hashlib
import os
import shutil
import subprocess

import torch

from orb_slam2_tpu_torch.frontend import fast

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fast_nms.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0
_lib = None


def fast_nms_raw_plain(img: torch.Tensor):
    """(nms, raw) in tensor ops: `nms3x3(fast_score_map(img))`."""
    raw = fast.fast_score_map(img)
    return fast.nms3x3(raw), raw


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit's standard location."""
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile csrc/fast_nms.cu into a shared library (once per source
    content) and return its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libfast_nms_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) + \
        ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


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
