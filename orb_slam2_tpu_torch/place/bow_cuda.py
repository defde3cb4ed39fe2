"""Scores of one BoW query against the listed rows of a keyframe table: the
wrapper of the CUDA kernel in csrc/bow_score.cu.

`table_scores_cuda(query, table, rows)` returns `(score [R] f32, shared
[R] int32)` for a query [W] f32, a table [K, W] f32 and row ids rows [R],
all on one CUDA device: one call of the kernel (built with nvcc for sm_90a
into `_build/` at first use and loaded with ctypes) reads each listed row
once and gives its L1 score and its shared-word count; a row id outside
[0, K) (-1) is skipped and gives 0 and 0.  `place.vocab.table_scores` takes
it for CUDA tensors and its plain version for CPU tensors; there is no
fallback from one to the other: a CUDA call that the kernel cannot take
raises.  Nothing here reads the device from the host.

The kernel replaces no TPU kernel: it is added because scoring a query
against the [2048, 10^6] table of the reference vocabulary's width is bound
by bytes, and only the live keyframes' rows need to be read.

`device_counts()` reads the calls and the rows they scored as the kernel
counts them on the device (also under CUDA graph replay);
`reset_device_counts()` zeroes them.  A call on CPU tensors counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_tpu_torch import cuda_build
from orb_slam2_tpu_torch.core import control

SOURCE = cuda_build.source("bow_score.cu")

_lib = None
_counts = {}        # device -> int32 [2]: calls, rows scored


def _count_buffer(dev: torch.device) -> torch.Tensor:
    t = _counts.get(dev)
    if t is None:
        t = _counts[dev] = control.register(
            torch.zeros(2, dtype=torch.int32, device=dev))
    return t


def device_counts():
    """(calls, rows scored) counted by the kernel on every device."""
    tot = [0, 0]
    for t in _counts.values():
        a, b = t.tolist()
        tot[0] += a
        tot[1] += b
    return tuple(tot)


def reset_device_counts():
    for t in _counts.values():
        t.zero_()


def build(verbose: bool = False) -> str:
    """Compile csrc/bow_score.cu (once per source content); its path."""
    return cuda_build.build(SOURCE, verbose)


def load():
    """The kernel's library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bow_score_launch.argtypes = [p, p, p, ll, ll, i, p, p, p, p, p, p]
        lib.bow_score_launch.restype = ctypes.c_int
        lib.bow_score_segments.argtypes = [ll]
        lib.bow_score_segments.restype = ll
        _lib = lib
    return _lib


def _check(query: torch.Tensor, table: torch.Tensor, rows: torch.Tensor):
    for name, t in (("query", query), ("table", table), ("rows", rows)):
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA {name}, got one on {t.device}")
    if len({query.device, table.device, rows.device}) != 1:
        raise ValueError(f"query, table and rows lie on {query.device}, "
                         f"{table.device} and {rows.device}")
    if table.dim() != 2 or table.dtype != torch.float32 or \
            not table.is_contiguous():
        raise ValueError(f"expected a contiguous [K, W] float32 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if query.shape != table.shape[1:] or query.dtype != torch.float32:
        raise ValueError(f"expected a [{table.shape[1]}] float32 query, got "
                         f"{tuple(query.shape)} {query.dtype}")
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected [R] int32 or int64 row ids, got "
                         f"{tuple(rows.shape)} {rows.dtype}")


def table_scores_cuda(query: torch.Tensor, table: torch.Tensor,
                      rows: torch.Tensor):
    """One call of the kernel on CUDA tensors: (score [R] f32, shared [R]
    int32) of `query` against the rows `rows` of `table`."""
    _check(query, table, rows)
    K, W = table.shape
    R = rows.shape[0]
    dev = table.device
    score = torch.empty(R, dtype=torch.float32, device=dev)
    shared = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return score, shared
    lib = load()
    query = query.contiguous()
    rows = rows.long().contiguous()
    n_seg = lib.bow_score_segments(W)
    part_l1 = torch.empty(R * n_seg, dtype=torch.float32, device=dev)
    part_sw = torch.empty(R * n_seg, dtype=torch.int32, device=dev)
    count = _count_buffer(dev)
    err = cuda_build.launch(dev, lib.bow_score_launch, query.data_ptr(),
                            table.data_ptr(), rows.data_ptr(), K, W, R,
                            part_l1.data_ptr(), part_sw.data_ptr(),
                            score.data_ptr(), shared.data_ptr(),
                            count.data_ptr())
    if err != 0:
        raise RuntimeError(f"bow_score kernel launch failed: cudaError {err}")
    return score, shared
