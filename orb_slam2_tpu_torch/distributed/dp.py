"""Data-parallel multi-sequence SLAM: S independent RGB-D sequences, one
map each, stepped in lock-step by ONE device program (port of
orb_slam2_tpu/distributed/dp.py).

The JAX package vmaps its per-frame program over a leading sequence axis
and jits it.  Here the states are the same NamedTuples with a leading [S]
axis on every field, allocated once, and every op of the step runs once
over that axis, as under JAX's vmap: one step extracts the S images in
one batched atlas program (one FAST launch over 8·S planes), tracks the S
sequences in one batched pass (`tracking.build_track_step`, one pose-LM
launch for all S problems at a time), inserts the keyframes of the
sequences that need one in one batched call (`system.insert_kf`) and
advances every pending integration by one batched call a stage group
(`system.mapping_stage`: triangulate, fuse, a BA chunk, cull), on a
dense batch of the sequences at that stage (`system.on_sequences`: the
next power of two of their count, all S once that reaches S).  Where JAX
branches with `lax.cond` / `lax.switch`, which its vmap turns into a
select, a branch here runs once for all S under a device branch
(`core.control.cond`) on "some sequence takes it", and each sequence
keeps its own branch's values (`map.state.seq_where`), the values it gets
alone: an op whose kernel depends on the batch (a cuBLAS product, the LU
solve, a long float sum) runs once a sequence (`core.seqwise`), so each
sequence's bits are those of its S = 1 run.  `init` is one batched call
too.  Eagerly (on the CPU, and with `capture=False`) the step's only host
reads are the helpers' marked predicate reads.  On the card `DPProgram`
captures the step as one CUDA graph at its first step and replays it, so
the host reads nothing from `init` to the end of the run; the branches
are IF nodes.  Each step is a `step` span of the span log
(`core/spans.py`, caused by its step number; the capture a `capture`
span inside the first), with a device interval from an event before its
input copies to one after its HUD copy, read at a later step once the
card has passed it, or at `huds()`.

The sequence axis needs no communication: `shard_batch` gives rank r of a
process group its own block of sequences, `build_sharded_step` steps it
with no collective, and `collective_ops_in_trace` counts the collectives
of a profiled step, which must be zero.

dp keeps its own schedule (dp.py:31-33, 99-109 in the JAX package): a
fixed N_STAGES = 2 + 3 + 1 integration stages of BA_ITERS = 5 LM
iterations per BA chunk, a keyframe while the previous one is still
triangulating or fusing is skipped, and there is no vocabulary, loop
closing or relocalisation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.config import RGBD, SLAMConfig
from orb_slam2_tpu_torch.core import control, lie, spans
from orb_slam2_tpu_torch.map.state import MapState, empty_map, seq_where
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import init as init_mod
from orb_slam2_tpu_torch.pipeline import system, tracking
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_N_MP, HUD_NEED_KF,
                                                   TrackState, record_traj)

BA_CHUNKS = 3
BA_ITERS = system.BA_ITERS      # 5: each chunk's LM iterations
N_STAGES = 2 + BA_CHUNKS + 1
HUD_LEN = HUD_N_MP + 1          # the track step's HUD: status .. n_mp
# the step's phases are host ranges of this prefix (extract, track,
# insert, stage): a torch.profiler trace charges the device work they
# launch to them (`dp_profile.charge`); without a profiler they cost
# nothing on the device
PHASE = "dp_phase/"

# names of the communication events in a torch.profiler trace
_COMM_PREFIXES = ("c10d::", "gloo:", "nccl", "record_param_comms")
_COLLECTIVES = ("allreduce", "allgather", "reducescatter", "broadcast",
                "alltoall", "send", "recv")


def _bodies(cfg: SLAMConfig, dev: torch.device):
    """(init_body, step_body) over the stacked (state, ts), in place:

        init_body((state, ts), img [S, H, W], depth [S, H, W])
        step_body((state, ts), img, depth, fid [S], t [S], hud [S, HUD_LEN])
    """
    if cfg.sensor != RGBD:
        raise ValueError("the DP driver batches RGB-D sequences")
    track = tracking.build_track_step(cfg)
    frame_fns = {}

    def frames(img, depth, fid, t):
        """The S frames as one Frame with a leading [S] axis."""
        S = img.shape[0]
        if S not in frame_fns:
            frame_fns[S] = frame_mod.build_rgbd_frame_fn(cfg, dev, n_images=S)
        if S == 1:
            one = frame_fns[1](img[0], depth[0], fid[0], t[0])
            return type(one)(*(x[None] for x in one))
        return frame_fns[S](img, depth, fid, t)

    def init_body(stacked, img, depth):
        state, ts = stacked
        S = img.shape[0]
        fr = frames(img, depth,
                    torch.zeros(S, dtype=torch.int32, device=img.device),
                    torch.zeros(S, dtype=torch.float32, device=img.device))
        enough = fr.n >= cfg.tracking.stereo_init_min_kps

        def do(st, tt):
            st1, tt1, _ = init_mod.stereo_initialize(st, tt, fr, cfg)
            return seq_where(enough, (st1, record_traj(st1, tt1, fr, True)),
                             (st, tt))

        st1, tt1 = control.cond(enough.any(), do, control.identity,
                                (state, ts))
        system.assign(state, st1)
        system.assign(ts, tt1)

    def step_body(stacked, img, depth, fid, t, hud):
        state, ts = stacked
        with record_function(PHASE + "extract"):
            fr = frames(img, depth, fid, t)
        with record_function(PHASE + "track"):
            st, tt, cur_pids, h = track(state, ts, fr)
        hud.copy_(h)
        busy_early = (tt.map_kf >= 0) & (tt.map_stage <= 1)
        need = (h[:, HUD_NEED_KF] > 0) & ~busy_early

        def insert(a, b):
            return seq_where(need, system.insert_kf(a, b, fr, cur_pids, cfg,
                                                    need), (a, b))

        with record_function(PHASE + "insert"):
            st, tt = control.cond(need.any(), insert, control.identity,
                                  (st, tt))
        with record_function(PHASE + "stage"):
            st, tt = system.mapping_stage(st, tt, cfg, N_STAGES)
        system.assign(state, st)
        system.assign(ts, tt)

    return init_body, step_body


def build_dp_step(cfg: SLAMConfig, device=None):
    """Returns (init_fn, step_fn), the eager step over stacked states, on
    `device` (CUDA unless the caller names one):

        init_fn(state, ts, img [S, H, W], depth [S, H, W]) -> (state, ts)
        step_fn(state, ts, img, depth, fid [S], t [S])
            -> (state, ts, hud [S, 5])

    Both write their results into `state` and `ts` and return them (the
    state is consumed, as a donated argument of a jitted function is).
    The step is the session's per-frame program (tracking + the staged
    LocalMapping) minus the host-driven rare events (loop closing,
    relocalisation), which are not on the throughput path.  `DPProgram`
    runs the same step captured."""
    dev = resolve_device(device)
    init_body, step_body = _bodies(cfg, dev)

    def init_fn(state, ts, img, depth):
        init_body((state, ts), img, depth)
        return state, ts

    def step_fn(state, ts, img, depth, fid, t):
        hud = torch.empty((img.shape[0], HUD_LEN), dtype=torch.int32,
                          device=img.device)
        step_body((state, ts), img, depth, fid, t, hud)
        return state, ts, hud

    return init_fn, step_fn


class DPProgram:
    """S RGB-D sequences stepped together as one program.  Usage:

        prog = DPProgram(cfg, S)            # CUDA; device="cpu" to opt out
        prog.init(img0, depth0)             # [S, H, W] each
        for f in range(1, F):
            prog.step(img[:, f], depth[:, f], f, t[:, f])
        trajs = trajectories(prog.state, prog.ts, F)

    It holds the input buffers, the stacked state (fixed storage; assigning
    `prog.state` / `prog.ts` copies into it) and a ring of the steps' HUDs
    (`huds()`, read once at the end).  `init` runs eagerly; on the card
    the first `step` after it captures the step as one CUDA graph and
    every step replays it, its inputs copied into the buffers first (from
    the card or the host, asynchronously).  `capture=False` runs the step
    eagerly instead (on the CPU always).  A failed capture raises: there
    is no eager fallback."""

    def __init__(self, cfg: SLAMConfig, S: int, device=None,
                 capture: Optional[bool] = None):
        self.cfg, self.S = cfg, S
        self.device = dev = resolve_device(device)
        cuda = dev.type == "cuda"
        if capture and not cuda:
            raise ValueError("a CUDA graph needs a CUDA device")
        self.capture = cuda if capture is None else capture
        self._init_body, self._step_body = _bodies(cfg, dev)
        self._state, self._ts = make_batch_states(cfg, S, dev)
        H, W = cfg.camera.height, cfg.camera.width
        self._img = torch.zeros((S, H, W), device=dev)
        self._depth = torch.zeros((S, H, W), device=dev)
        self._fid = torch.zeros(S, dtype=torch.int32, device=dev)
        self._t = torch.zeros(S, device=dev)
        self._hud = torch.zeros((S, HUD_LEN), dtype=torch.int32, device=dev)
        self._huds = torch.zeros((cfg.cap.max_frames, S, HUD_LEN),
                                 dtype=torch.int32, device=dev)
        self.steps = 0
        self.graph_replays = 0
        self.capture_s = None        # seconds the warm-up and capture took
        #                              (its `capture` span)
        self._graph = None

    @property
    def state(self) -> MapState:
        return self._state

    @state.setter
    def state(self, new: MapState):
        system.assign(self._state, new)

    @property
    def ts(self) -> TrackState:
        return self._ts

    @ts.setter
    def ts(self, new: TrackState):
        system.assign(self._ts, new)

    def __del__(self):
        if control is not None and getattr(self, "_graph", None) is not None:
            control.release(self._graph)

    def _put(self, img, depth, fid, t):
        for buf, x in ((self._img, img), (self._depth, depth),
                       (self._fid, fid), (self._t, t)):
            if isinstance(x, (int, float)):
                buf.fill_(x)
            else:
                buf.copy_(torch.as_tensor(x), non_blocking=True)

    def init(self, img, depth):
        """Initialise each sequence on its first frame (eagerly, once)."""
        with spans.span("init", 0, self.device):
            self._put(img, depth, 0, 0.0)
            with control.sync_allowed(self.device):
                self._init_body((self._state, self._ts), self._img,
                                self._depth)

    def step(self, img, depth, fid, t):
        """One frame of every sequence: images and depth maps [S, H, W],
        frame ids and timestamps [S] (or one number for all)."""
        spans.ready()
        with spans.span("step", self.steps, self.device):
            self._put(img, depth, fid, t)
            if not self.capture:
                self._step_body((self._state, self._ts), self._img,
                                self._depth, self._fid, self._t, self._hud)
            else:
                if self._graph is None:
                    self._graph = self._capture_program()
                self._graph.replay()
                self.graph_replays += 1
            self._huds[self.steps % self._huds.shape[0]].copy_(self._hud)
        self.steps += 1

    def _capture_program(self) -> torch.cuda.CUDAGraph:
        """The step captured on the fixed buffers, its results written
        back in place (`control.capture_program`: warmed up on copies of
        the state first; a failure raises)."""
        def run(on_copies: bool):
            stacked, hud = (self._state, self._ts), self._hud
            if on_copies:
                stacked = (system.clone(self._state), system.clone(self._ts))
                hud = hud.clone()
            self._step_body(stacked, self._img, self._depth, self._fid,
                            self._t, hud)

        with spans.span("capture") as sp:
            g = control.capture_program(run, self.device)
        self.capture_s = sp.dur
        return g

    def huds(self) -> np.ndarray:
        """The HUDs of the last steps (up to `cfg.cap.max_frames`), in
        step order: [steps, S, 5] (a host read)."""
        R = self._huds.shape[0]
        n = min(self.steps, R)
        order = [(self.steps - n + i) % R for i in range(n)]
        out = self._huds[order].cpu().numpy()
        spans.ready()
        return out


def make_batch_states(cfg: SLAMConfig, S: int, device=None):
    """S stacked fresh (MapState, TrackState), on `device` (CUDA unless the
    caller names one)."""
    dev = resolve_device(device)
    tile = lambda x: x[None].repeat((S,) + (1,) * x.dim())
    return (MapState(*map(tile, empty_map(cfg, dev))),
            TrackState(*map(tile, tracking.empty_track_state(cfg, dev))))


def trajectories(state, ts, n_frames: int):
    """Per sequence, (timestamps [n], Twc [n, 7]) of its tracked frames
    among the first `n_frames`: each frame's pose relative to its
    reference keyframe times that keyframe's current pose, as the
    session's trajectory export rebuilds it."""
    out = []
    for s in range(ts.traj.shape[0]):
        traj = ts.traj[s, :n_frames]
        ref = traj[:, 14].to(torch.int64).clamp(min=0)
        Twc = lie.se3_inverse(lie.se3_compose(traj[:, 7:14],
                                              state.kf_pose[s][ref]))
        ok = (traj[:, 15] > 0.5) & (traj[:, 14] >= 0)
        out.append((traj[ok, 16].cpu().numpy(), Twc[ok].cpu().numpy()))
    return out


def shard_batch(tree, group):
    """Rank r of `group` (n ranks) keeps sequences [r·S/n, (r+1)·S/n) of a
    stacked tree (tensors, NamedTuples, tuples, lists) in storage of its
    own (the dp step writes its state in place), CUDA tensors on the
    rank's current card."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def shard(x):
        if torch.is_tensor(x):
            S = x.shape[0]
            x = x[r * S // n:(r + 1) * S // n]
            return x.to(torch.cuda.current_device() if x.is_cuda
                        else x.device, copy=True)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(shard, x))
        return type(x)(map(shard, x))

    return shard(tree)


def build_sharded_step(cfg: SLAMConfig, group, device=None):
    """The rank's (init, step) over its shard of the sequences
    (`shard_batch(..., group)`): `build_dp_step` on the rank's device (a
    rank that wants the captured program makes a `DPProgram` over its
    shard and assigns the shard to its state).  The sequence axis is
    embarrassingly parallel, so the step issues no collective
    (`collective_ops_in_trace` of a profiled step is 0)."""
    if dist.get_rank(group) < 0:
        raise ValueError("this process is not in the group")
    return build_dp_step(cfg, device)


def collective_ops_in_trace(prof) -> int:
    """Count the collective events (all-reduce, all-gather, reduce-scatter,
    broadcast, all-to-all, send, recv) in a finished torch.profiler trace
    — the DP sequence axis must show none.  A gloo collective shows as two
    events: the c10d op and the backend's own.  Reads the raw trace
    events, not `prof.events()`, whose tree of a step's ~10^5 host ops
    takes far longer to build than the step."""
    n = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name().lower()
        if name.startswith(_COMM_PREFIXES) and any(
                c in name.replace("_", "") for c in _COLLECTIVES):
            n += 1
    return n
