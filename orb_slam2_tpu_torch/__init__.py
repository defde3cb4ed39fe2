"""orb_slam2_tpu_torch — the PyTorch/CUDA port of orb_slam2_tpu.

The JAX package `orb_slam2_tpu` is the reference this package is held
against (tests/test_torch_*.py run both on identical inputs).  The layout
mirrors it module for module (`core/`, `frontend/`, `matching/`, `map/`,
`solvers/`, `ba/`, `pipeline/`, `io/`) and keeps the JAX function names, so
every function has an obvious counterpart.  Inside, it is PyTorch idiom:
plain functions on tensors, `NamedTuple`s of tensors for the map and
tracking state, an explicit device, an explicit `torch.Generator` for
RANSAC.  The one kernel on the monocular path, the fused FAST-9 score + 3x3
NMS, is hand-written CUDA (`csrc/fast_nms.cu`, bound in
`frontend/fast_cuda.py`).

This package imports neither `jax` nor `orb_slam2_tpu`: it keeps its own
copies of the JAX-free pieces it needs (`config.py`, `io/`, the BRIEF
pattern in `data/`).
"""

import torch

# TF32 keeps ~10 mantissa bits.  Descriptor bits are the signs of an f32
# matmul (frontend/atlas.py) and bundle adjustment solves normal equations,
# so both must run in full float32, as the JAX reference does on the CPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    Raises when no CUDA device is present and none was named — the port
    never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
