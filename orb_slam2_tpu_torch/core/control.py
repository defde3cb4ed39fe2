"""Device-side control flow: `cond`, the port's counterpart of `lax.cond`
(the JAX step makes every per-frame decision with `lax.cond` /
`lax.switch`, inside one program; a switch here is one `cond` for each
distinct branch function, as `system.mapping_stage` runs its stages).

Eagerly (on the CPU, and on the card outside a capture) `cond` reads its
predicate once and runs the chosen branch: that read, made by `read_pred`
with `in_predicate_read()` true, is the only host read the helper makes.
While a CUDA graph is being captured (`capturing`), every branch is
captured into the body of a CUDA graph conditional IF node
(csrc/graph_cond.cu) whose condition the card sets from the predicate at
replay, so the branch is chosen on the device and the host reads nothing.

Results under capture live at fixed addresses.  When a branch returns the
structure of its operands (a carry, as `(state, ts)`), each result field
whose tensor changed is copied into the operand's own tensor inside the
body, and the operands are returned: the operands are consumed, as a
donated argument of a jitted JAX function is.  `identity` as a branch
captures nothing.  Other results (a few small tensors) are cloned by the
first branch into fresh tensors that the other branches copy into.

`warmup()` makes every `cond` run both of its branches eagerly (and return
the chosen one's result), so that a branch the data did not take has still
loaded its kernels and filled its caches before a capture.  `Count` is an
event count summed on the device in place, so that it also counts under
graph replay; `snapshot` / `restore` save and put back every count.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
from typing import Callable, List, Optional

import torch
import torch.utils._pytree as pytree

from orb_slam2_tpu_torch import cuda_build

SOURCE = cuda_build.source("graph_cond.cu")
MAX_DEPTH = 6          # nesting depth of IF nodes a capture can take

_lib = None
_pred_read = False
_warmup = False
_capture: Optional["_Capture"] = None
_registry: List[torch.Tensor] = []     # every device counter, see snapshot


def identity(*operands):
    """The branch that changes nothing (`lambda op: op`)."""
    return operands if len(operands) != 1 else operands[0]


def read_pred(x) -> int:
    """The helper's one host read: the predicate `x` as an int."""
    global _pred_read
    if not isinstance(x, torch.Tensor):
        return int(x)
    _pred_read = True
    try:
        return int(x)
    finally:
        _pred_read = False


def in_predicate_read() -> bool:
    """True while `read_pred` reads: tells its read apart from others."""
    return _pred_read


def capturing() -> bool:
    """True while a `capture` of a CUDA graph is open."""
    return _capture is not None


@contextlib.contextmanager
def warmup():
    """Run both branches of every `cond` (eagerly), returning the chosen
    one's result."""
    global _warmup
    old, _warmup = _warmup, True
    try:
        yield
    finally:
        _warmup = old


@contextlib.contextmanager
def sync_allowed(device: torch.device):
    """A region that may read the card (initialisation, a capture, a host
    reaction): CUDA's sync debug mode is off inside it."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# ---------------------------------------------------------------------------
# the branch
# ---------------------------------------------------------------------------

def cond(pred, true_fn: Callable, false_fn: Callable, operands=()):
    """`true_fn(*operands)` if pred else `false_fn(*operands)` (lax.cond).
    `pred`: a bool, or a 0-d bool tensor; both branches return the same
    structure of tensors of the same shapes and types."""
    if not isinstance(pred, torch.Tensor):
        return (true_fn if pred else false_fn)(*operands)
    if _capture is not None:
        return _capture.branches([pred, ~pred], [true_fn, false_fn],
                                 operands)
    if _warmup:
        outs = [fn(*operands) for fn in (true_fn, false_fn)]
        return outs[0] if read_pred(pred) else outs[1]
    return (true_fn if read_pred(pred) else false_fn)(*operands)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build(SOURCE))
        p = ctypes.c_void_p
        lib.graph_cond_begin_if.argtypes = [p, p, p]
        lib.graph_cond_begin_if.restype = ctypes.c_int
        lib.graph_cond_end.argtypes = [p]
        lib.graph_cond_end.restype = ctypes.c_int
        _lib = lib
    return _lib


_streams = {}


def body_streams(device: torch.device) -> List[torch.cuda.Stream]:
    """The streams IF bodies are captured on, one per nesting depth, made
    once per device, each with cuBLAS and cuSOLVER warmed on it (their
    per-stream workspaces cannot be made under capture)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _streams:
        with torch.cuda.device(idx):
            ss = [torch.cuda.Stream() for _ in range(MAX_DEPTH)]
            a = torch.eye(6, device=device)
            for s in ss:
                with torch.cuda.stream(s):
                    torch.linalg.solve_ex(a, a[0])
                    torch.linalg.inv_ex(a)
                    torch.bmm(a[None], a[None])
                    a @ a
            torch.cuda.synchronize(idx)
        _streams[idx] = ss
    return _streams[idx]


class _Capture:
    """State of one open capture: the body streams and the nesting depth;
    allocations on the body streams go to a pool of their own (the graph's
    pool takes only its capture stream's)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.streams = body_streams(device)
        self.depth = 0
        self.lib = _load()

    def branches(self, preds, fns, operands):
        tree = operands if len(operands) != 1 else operands[0]
        ins, in_spec = pytree.tree_flatten(tree)
        # a carry's fields are written in place: un-alias them first
        seen = set()
        for i, t in enumerate(ins):
            if isinstance(t, torch.Tensor) and t.numel():
                key = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                if key in seen:
                    ins[i] = t.clone()
                seen.add(key)
        tree = pytree.tree_unflatten(ins, in_spec)
        args = (tree,) if len(operands) == 1 else tree
        carry, homes, out_spec = False, None, None
        preds = [p.reshape(()).to(torch.bool).contiguous() for p in preds]
        for pred, fn in zip(preds, fns):
            if fn is identity:
                carry = True
                continue
            with self._body(pred):
                leaves, spec = pytree.tree_flatten(fn(*args))
                if spec == in_spec and ins:
                    carry = True
                    self._copy(leaves, ins)
                elif carry or (out_spec is not None and spec != out_spec):
                    raise ValueError("cond branches return different "
                                     "structures")
                elif homes is None:
                    homes = [t.clone() if isinstance(t, torch.Tensor) else t
                             for t in leaves]
                    out_spec = spec
                else:
                    self._copy(leaves, homes)
        if carry:
            if homes is not None:
                raise ValueError("cond branches return different "
                                 "structures")
            return tree
        return pytree.tree_unflatten(homes, out_spec)

    @staticmethod
    def _copy(srcs, dsts):
        pairs = []
        for s, d in zip(srcs, dsts):
            if not isinstance(d, torch.Tensor):
                if s != d:
                    raise ValueError("a branch changed a non-tensor field")
                continue
            if s is d:
                continue
            if s.shape != d.shape or s.dtype != d.dtype:
                raise ValueError(f"branch result {s.dtype} {tuple(s.shape)} "
                                 f"!= {d.dtype} {tuple(d.shape)}")
            pairs.append((s, d))
        # a result that is another field's home is read before it is written
        homes = {d.data_ptr() for _, d in pairs}
        pairs = [(s.clone() if s.data_ptr() in homes else s, d)
                 for s, d in pairs]
        for s, d in pairs:
            d.copy_(s)

    @contextlib.contextmanager
    def _body(self, pred: torch.Tensor):
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"IF nodes nested deeper than {MAX_DEPTH}")
        parent = torch.cuda.current_stream(self.device)
        child = self.streams[self.depth]
        err = self.lib.graph_cond_begin_if(pred.data_ptr(),
                                           parent.cuda_stream,
                                           child.cuda_stream)
        if err != 0:
            raise RuntimeError(f"graph_cond_begin_if failed: cudaError {err}")
        self.depth += 1
        try:
            with torch.cuda.stream(child):
                yield
        finally:
            self.depth -= 1
            err = self.lib.graph_cond_end(child.cuda_stream)
            if err != 0:
                raise RuntimeError(f"graph_cond_end failed: cudaError {err}")


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device):
    """Capture `graph` (torch.cuda.graph, global capture mode) with `cond`
    building IF nodes.  A failure raises; nothing falls back to
    eager execution."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is already open")
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    cap = _Capture(torch.device("cuda", idx))
    body_pool = torch.cuda.graph_pool_handle()
    _release_deferred()
    # no garbage collection inside: a collected graph frees its memory,
    # which a capture forbids
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            torch._C._cuda_beginAllocateToPool(idx, body_pool)
            _capture = cap
            try:
                yield
            finally:
                _capture = None
                torch._C._cuda_endAllocateToPool(idx, body_pool)
    finally:
        if gc_was_on:
            gc.enable()
    graph._body_pool = (idx, body_pool)


def capture_program(run: Callable[[bool], None],
                    device: torch.device) -> torch.cuda.CUDAGraph:
    """A program's CUDA graph: `run(True)` (the program on copies of its
    buffers) runs eagerly with every branch warmed up (kernels loaded,
    caches and counters made; the counts put back), then `run(False)`
    (the program on its buffers, results written back in place) is
    captured.  A failure raises: there is no eager fallback."""
    with sync_allowed(device):
        snap = snapshot()
        with warmup():
            run(True)
        restore(snap)
        body_streams(device)
        torch.cuda.synchronize(device)
        g = torch.cuda.CUDAGraph()
        with capture(g, device):
            run(False)
    return g


_deferred: List[torch.cuda.CUDAGraph] = []


def release(graph: torch.cuda.CUDAGraph):
    """Free `graph` and the pool of its IF bodies (after the capture that
    is open, if one is: a capture forbids freeing)."""
    if _capture is not None or torch.cuda.is_current_stream_capturing():
        _deferred.append(graph)
        return
    pool = getattr(graph, "_body_pool", None)
    graph.reset()
    if pool is not None:
        torch._C._cuda_releasePool(*pool)
        graph._body_pool = None


def _release_deferred():
    while _deferred:
        release(_deferred.pop())


# ---------------------------------------------------------------------------
# device counts
# ---------------------------------------------------------------------------

def register(t: torch.Tensor) -> torch.Tensor:
    """Add a device counter to the ones `snapshot` / `restore` cover; a
    counter must exist before a capture that bumps it."""
    if _capture is not None:
        raise RuntimeError("a device counter was first used under capture; "
                           "run the step eagerly once first")
    _registry.append(t)
    return t


def snapshot():
    """The values of every device counter, for `restore`."""
    return len(_registry), [t.clone() for t in _registry]


def restore(snap):
    """Put the counters back as `snapshot` found them; counters made since
    go back to zero."""
    n, vals = snap
    for t, v in zip(_registry, vals):
        t.copy_(v)
    for t in _registry[n:]:
        t.zero_()


class Count:
    """A count of events summed on the device in place (one int64 per
    device), so that a replayed graph adds to it too.  `int(c)` reads it
    (a host read: outside the step), `reset()` restarts it."""

    def __init__(self):
        self._t = {}

    def _of(self, device: torch.device) -> torch.Tensor:
        t = self._t.get(device)
        if t is None:
            t = self._t[device] = register(
                torch.zeros((), dtype=torch.int64, device=device))
        return t

    def add(self, x: torch.Tensor):
        self._of(x.device).add_(x.to(torch.int64))

    def tick(self, device: torch.device):
        """Count one event (a scalar add: no host-to-device copy)."""
        self._of(device).add_(1)

    def reset(self):
        for t in self._t.values():
            t.zero_()

    def __int__(self):
        return sum(int(t) for t in self._t.values())

    def __repr__(self):
        return f"Count({int(self)})"
