"""Motion-only pose LM as one CUDA kernel launch: the wrapper of
csrc/pose_lm.cu.

Replaces the Pallas TPU kernel scripts/study_pallas_pose.py `_make_kernel`
(`pose_optimize_pallas`, the TPU drop-in for `pose_optimize`).  One launch
runs the whole schedule of `pose_optimize_plain` (solvers/pose_opt.py) for B
problems, one thread-block cluster each, including the JAX main path's
convergence stop, so a tracked frame's pose LM is one launch instead of
thousands of small tensor ops.

What bounds it on the H100: neither bytes (~31 KB a problem at N = 1024)
nor FP32 operations (~1e7 a problem) but the serial chain of up to 40 LM
iterations.  The kernel spreads a problem over a cluster of blocks and
makes each iteration one pass over the points held in registers and one
reduction, exchanged through distributed shared memory and mbarriers, with
the 6x6 solve repeated in every thread instead of broadcast from one; it
sums in a fixed order without atomics, so launches are bit-identical.

`device_launches()` reads the launches as the kernel counts them on the
device (also under CUDA graph replay; a batch of B problems is one),
`reset_device_launches()` zeroes them.  `load(cluster)` and
`run(lib, ...)` give the same kernel built with another cluster size, to
time it, uncounted; the main path always takes the source's own.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.config import BAConfig
from orb_slam2_tpu_torch.core import control

SOURCE = cuda_build.source("pose_lm.cu")

_lib = None
_counts = {}        # device -> int32 [1]


def device_launches() -> int:
    """Launches counted by the kernel on every device."""
    return sum(int(t) for t in _counts.values())


def reset_device_launches():
    for t in _counts.values():
        t.zero_()


def build(verbose: bool = False, cluster=None) -> str:
    """Compile csrc/pose_lm.cu (once per source content and cluster size;
    None keeps the source's own); its path."""
    defines = () if cluster is None else (f"-DPOSE_LM_CLUSTER={cluster}",)
    return cuda_build.build(SOURCE, verbose, defines)


def open_library(path: str):
    """A built library of the kernel, with `max_points`, the largest N a
    launch takes, and `cluster`, its blocks per problem."""
    lib = ctypes.CDLL(path)
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.pose_lm_launch.argtypes = [p] * 8 + [f] * 7 + [i] * 4 + [p] * 7
    lib.pose_lm_launch.restype = ctypes.c_int
    for fn in (lib.pose_lm_max_points, lib.pose_lm_cluster):
        fn.argtypes, fn.restype = [], ctypes.c_int
    lib.max_points = lib.pose_lm_max_points()
    lib.cluster = lib.pose_lm_cluster()
    return lib


def load(cluster=None):
    """The kernel's library, built on first use (`cluster`: another cluster
    size than the source's own)."""
    global _lib
    if cluster is None and _lib is not None:
        return _lib
    lib = open_library(build(cluster=cluster))
    if cluster is None:
        _lib = lib
    return lib


def pose_lm_cuda(T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo, K,
                 bf: float, cfg: BAConfig = BAConfig()):
    """B pose problems in one launch.

    T0 [B, 7]; pw [B, N, 3]; obs_uv [B, N, 2]; obs_ur, inv_sigma2 [B, N]
    float32; valid, is_stereo [B, N] bool; K [4] float32 — all on one CUDA
    device.  Returns (T [B, 7], inliers [B, N] bool, n_inliers [B] int32,
    chi2 [B] float32 summed over the inliers, n_iter [B] int32 LM
    iterations run over all rounds)."""
    count = _counts.get(T0.device)
    if count is None:
        count = _counts[T0.device] = control.register(
            torch.zeros((), dtype=torch.int32, device=T0.device))
    return run(None, T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo,
               K, bf, cfg, count)


def run(lib, T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo, K,
        bf: float, cfg: BAConfig = BAConfig(), count=None):
    """`pose_lm_cuda` through the library `lib` (from `load`; None: the
    source's own), counted only into the int32 device tensor `count` when
    one is given.  Refuses bad input before building."""
    B, N = valid.shape
    ins = (T0, pw, obs_uv, obs_ur, inv_sigma2, valid, is_stereo, K)
    want = (((B, 7), torch.float32), ((B, N, 3), torch.float32),
            ((B, N, 2), torch.float32), ((B, N), torch.float32),
            ((B, N), torch.float32), ((B, N), torch.bool),
            ((B, N), torch.bool), ((4,), torch.float32))
    dev = T0.device
    for t, (shape, dtype) in zip(ins, want):
        if not t.is_cuda or t.device != dev or t.shape != shape or \
                t.dtype != dtype:
            raise ValueError(f"pose_lm_cuda expects {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if B < 1 or N < 1:
        raise ValueError(f"empty problem batch B={B}, N={N}")
    if lib is None:
        lib = load()
    if N > lib.max_points:
        raise ValueError(f"N={N} points exceed the kernel's {lib.max_points}")
    ins = [t if t.is_contiguous() else t.contiguous() for t in ins]
    T = torch.empty((B, 7), dtype=torch.float32, device=dev)
    inl = torch.empty((B, N), dtype=torch.bool, device=dev)
    n_in = torch.empty(B, dtype=torch.int32, device=dev)
    chi2 = torch.empty(B, dtype=torch.float32, device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    err = cuda_build.launch(
        dev, lib.pose_lm_launch, *[t.data_ptr() for t in ins], float(bf),
        cfg.chi2_mono, cfg.chi2_stereo, cfg.huber_mono ** 2,
        cfg.huber_stereo ** 2, cfg.lm_lambda_init, cfg.lm_lambda_factor,
        cfg.pose_opt_rounds, cfg.pose_opt_iters, B, N, T.data_ptr(),
        inl.data_ptr(), n_in.data_ptr(), chi2.data_ptr(), n_iter.data_ptr(),
        None if count is None else count.data_ptr())
    if err != 0:
        raise RuntimeError(f"pose_lm kernel launch failed: cudaError {err}")
    return T, inl, n_in, chi2, n_iter
