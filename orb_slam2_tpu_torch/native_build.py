"""Build a C++ helper of `native/` into a shared library and load it.

The helpers (the ORBvoc text parser, PNG unfiltering) expose plain C
functions for ctypes.  They compile with g++ on first use into the
gitignored `_build/`, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one is reused; no binary is kept
in the repository.  `load` returns None only when no compiler is present
(saying so once on stderr), and the callers then take their plain Python
versions; a compiler that is present and fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()


class NoCompiler(RuntimeError):
    """No C++ compiler: neither `CXX` nor g++ on PATH."""


def build(name: str) -> str:
    """Compile `native/<name>.cpp` into `_build/lib<name>_<hash>.so` unless
    that exists; return its path.  Raises NoCompiler when there is no
    compiler and RuntimeError when it fails."""
    src = os.path.join(PKG, "native", f"{name}.cpp")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NoCompiler("no C++ compiler: CXX is unset and g++ is not on "
                         "PATH")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, src],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> Optional[ctypes.CDLL]:
    """The helper's library, built on first use.  None when there is no
    compiler, with a warning on stderr the first time; a failed build or
    load raises."""
    with _lock:
        if name not in _libs:
            try:
                _libs[name] = ctypes.CDLL(build(name))
            except NoCompiler as e:
                print(f"warning: {e}; the plain Python version of "
                      f"native/{name}.cpp runs instead, many times slower",
                      file=sys.stderr)
                _libs[name] = None
        return _libs[name]
