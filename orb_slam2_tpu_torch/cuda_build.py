"""Build a hand-written CUDA source of `csrc/` into a shared library.

Each kernel source exposes a plain C launcher (pointers and the stream as
`void*`, returning `cudaGetLastError()`), so it compiles with nvcc alone, in
seconds, without PyTorch's headers, and loads with ctypes.  Libraries go to
the gitignored `_build/`, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one is reused.  Nothing here runs
when a module is imported: the first launch builds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

import torch

PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def source(name: str) -> str:
    return os.path.join(PKG, "csrc", name)


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit's standard location."""
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(src: str, verbose: bool = False, defines=()) -> str:
    """Compile `src` into `_build/lib<stem>_<hash>.so` unless that exists;
    return its path.  `defines` are extra `-D` flags (a variant of the
    source's compile-time constants).  With `verbose`, print ptxas's
    register, shared-memory and spill counts."""
    flags = NVCC_FLAGS + list(defines)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + flags + (["-Xptxas", "-v"] if verbose else []) + \
        ["-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip(), flush=True)
    os.replace(tmp, out)
    return out


def launch(dev: torch.device, fn, *args) -> int:
    """Call the C launcher `fn(*args, stream)` with the raw handle of the
    current stream of CUDA device `dev`, that device current for the call
    (a guard only when another device is current).  Returns `fn`'s error
    code."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)
