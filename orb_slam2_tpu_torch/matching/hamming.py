"""Exact Hamming distances (port of orb_slam2_tpu/matching/hamming.py).

The JAX package forms the +-1 rows in bfloat16 for the TPU's matrix unit.
Here the +-1 rows are float32: every product is +-1 and every partial sum an
integer of magnitude <= 256, so a float32 product (TF32 off, see
package __init__) equals the true popcount distance exactly.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.frontend.orb import unpack_bits

N_BITS = 256


def pm1_from_packed(desc: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] float32 +-1 rows."""
    bits = unpack_bits(desc)
    return torch.where(bits, 1.0, -1.0).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Packed descriptors [..., Na, 32], [..., Nb, 32] -> int32 Hamming
    [..., Na, Nb]: with leading batch axes, one batched product."""
    dot = pm1_from_packed(desc_a) @ pm1_from_packed(desc_b).transpose(-1, -2)
    return ((N_BITS - dot) * 0.5).to(torch.int32)


def hamming_rows(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-wise Hamming distance between aligned [N, 32] packed arrays."""
    dot = torch.sum(pm1_from_packed(desc_a) * pm1_from_packed(desc_b), dim=-1)
    return ((N_BITS - dot) * 0.5).to(torch.int32)
