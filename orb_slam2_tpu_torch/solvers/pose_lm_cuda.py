"""Motion-only pose LM as one CUDA kernel launch: the wrapper of
csrc/pose_lm.cu.

Replaces the Pallas TPU kernel scripts/study_pallas_pose.py `_make_kernel`
(`pose_optimize_pallas`, the TPU drop-in for `pose_optimize`).  One launch
runs the whole schedule of `pose_optimize_plain` (solvers/pose_opt.py) for B
problems, one thread block each, including the JAX main path's convergence
stop, so a tracked frame's pose LM is one launch instead of thousands of
small tensor ops.

What bounds it on the H100: neither bytes (~31 KB a problem at N = 1024)
nor FP32 operations (at most ~1.4e7 a problem) but the serial chain of an
LM iteration inside one block — two block reductions, a 6x6 Cholesky on one
thread, five barriers — repeated up to 40 times.  The design keeps that
chain on the SM (no host round trip, no launch between iterations) and
sums in a fixed order without atomics, so launches are bit-identical.

`launches` counts launches of the kernel (a batch of B problems is one).
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.config import BAConfig

SOURCE = cuda_build.source("pose_lm.cu")

launches = 0
_lib = None


def build(verbose: bool = False) -> str:
    """Compile csrc/pose_lm.cu (once per source content); its path."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.pose_lm_launch.argtypes = [p] * 8 + [f] * 7 + [i] * 4 + [p] * 6
        lib.pose_lm_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def pose_lm_cuda(T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo, K,
                 bf: float, cfg: BAConfig = BAConfig()):
    """B pose problems in one launch.

    T0 [B, 7]; pw [B, N, 3]; obs_uv [B, N, 2]; obs_ur, inv_sigma2 [B, N]
    float32; valid, is_stereo [B, N] bool; K [4] float32 — all on one CUDA
    device.  Returns (T [B, 7], inliers [B, N] bool, n_inliers [B] int32,
    chi2 [B] float32 summed over the inliers, n_iter [B] int32 LM
    iterations run over all rounds)."""
    global launches
    B, N = valid.shape
    want = ((T0, (B, 7), torch.float32), (pw, (B, N, 3), torch.float32),
            (obs_uv, (B, N, 2), torch.float32),
            (obs_ur, (B, N), torch.float32),
            (inv_sigma2, (B, N), torch.float32), (valid, (B, N), torch.bool),
            (is_stereo, (B, N), torch.bool), (K, (4,), torch.float32))
    dev = T0.device
    for t, shape, dtype in want:
        if not t.is_cuda or t.device != dev or tuple(t.shape) != shape or \
                t.dtype != dtype:
            raise ValueError(f"pose_lm_cuda expects {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if B < 1 or N < 1:
        raise ValueError(f"empty problem batch B={B}, N={N}")
    ins = [t.contiguous() for t, _, _ in want]
    T = torch.empty((B, 7), dtype=torch.float32, device=dev)
    inl = torch.empty((B, N), dtype=torch.bool, device=dev)
    n_in = torch.empty(B, dtype=torch.int32, device=dev)
    chi2 = torch.empty(B, dtype=torch.float32, device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.pose_lm_launch(
            *[t.data_ptr() for t in ins], float(bf), cfg.chi2_mono,
            cfg.chi2_stereo, cfg.huber_mono ** 2, cfg.huber_stereo ** 2,
            cfg.lm_lambda_init, cfg.lm_lambda_factor, cfg.pose_opt_rounds,
            cfg.pose_opt_iters, B, N, T.data_ptr(), inl.data_ptr(),
            n_in.data_ptr(), chi2.data_ptr(), n_iter.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_lm kernel launch failed: cudaError {err}")
    launches += 1
    return T, inl, n_in, chi2, n_iter
