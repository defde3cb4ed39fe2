"""Ops that run once a sequence over a leading sequence axis [S].

A batch of S sequences must give each sequence the bits of its S = 1
call.  Elementwise ops, gathers, integer scatters and short reductions do
so by construction.  A cuBLAS GEMM (batched or not), a cuSOLVER LU and a
long float reduction do not: their kernel, and with it the order of their
float sums, depends on the batch, and on the card it changes with S.  Such
an op runs through `each`, one call a sequence, each the call an S = 1
batch (and an unbatched caller) makes.
"""

from __future__ import annotations

import torch


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a 16-byte aligned address (vectorised loads
    and cuBLAS's kernel choice look at a pointer's alignment)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def each(fn, *xs: torch.Tensor):
    """fn over each sequence's slice of the stacked tensors xs [S, ...],
    one call a sequence, the results stacked (a tensor, or a tuple of
    tensors).  `fn` takes and returns tensors without the axis; at S = 1
    it is one call on sequence 0, the call an unbatched caller makes."""
    S = xs[0].shape[0]
    if S == 1:
        out = fn(*(x[0] for x in xs))
        return tuple(o[None] for o in out) if isinstance(out, tuple) \
            else out[None]
    outs = [fn(*(_aligned(x[s]) for x in xs)) for s in range(S)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def total(x: torch.Tensor) -> torch.Tensor:
    """Each sequence's sum of its values x [S, ...]: [S]."""
    return each(torch.sum, x)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per sequence, `torch.bmm` of a [S, R, i, k] and b [S, R, k, j]."""
    return each(torch.bmm, a, b)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """Per sequence, `torch.einsum(eq, ...)` of the [S, ...] operands (eq
    written without the sequence axis)."""
    return each(lambda *x: torch.einsum(eq, *x), *xs)
