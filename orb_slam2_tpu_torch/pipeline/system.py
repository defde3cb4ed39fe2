"""SLAM session for a monocular, stereo or RGB-D camera (port of
orb_slam2_tpu/pipeline/system.py).

Per frame: build the frame (the sensor's frame function), track, decide
on a keyframe, insert it (with its depth points for stereo/RGB-D and its
BoW vector when a vocabulary is loaded), and advance the pending
keyframe's integration by one stage (triangulate, fuse, 3 local-BA chunks,
cull) — the deterministic form of the reference's LocalMapping thread.
Every decision of the step is a device branch (`core.control.cond`,
JAX's `lax.cond` / `lax.switch`), so the step reads nothing back on the
host.

On the card the session runs the step as ONE CUDA graph a frame, or one a
batch of `cfg.frame_batch = B` frames (B step bodies, each under a device
branch on its slot's `active` flag, as JAX's scanned `super_step`): it is
captured at the first tracked frame after initialisation (one graph for
mapping mode and one for localisation mode, each on first use) and
replayed.  The graph reads and writes the session's map and track state
in place: they are allocated once, and every host reaction writes into the
same storage.  Its inputs are fixed device buffers, filled by asynchronous
copies from a ring of pinned host buffers; the HUD that drives the host
reactions goes back the same way and is read `hud_lag` frames late, as in
the JAX package, so their timing matches: reset on early loss,
relocalisation when lost, loop detection on each new keyframe with Sim3
verification and correction, and one chunk of the post-loop global BA
between frames.  A failed capture raises.  On the CPU (and with
`capture=False`) the same program runs eagerly: the eager step
(`SLAM._full_step`, JAX's `_full_step_raw`) serves the CPU tests, the
phase timers of `frame_profile.py` and comparisons on the card.

Each `track_*` call is a `frame` span of the span log (`core/spans.py`;
its duration is the `SLAM.timings` entry): `init`; `dispatch` (its
`slot_wait`, `capture`, `replay`); `drain` (`hud_wait`, `reset`,
`reloc_launch`, `reloc_apply`, `detect_launch`, `loop_wait`, `verify`,
`correct`, `gba`), each reaction caused by the frame whose HUD entry
raised it.  `flush` (`stages`, `gba`, `sync`) and `reset` are spans of
their own.  A dispatch's device interval runs from an event before its
input copies to the staging slot's event after its HUD copy, read where
`_drain` waits on that event; a detection's, where `_check_loops` waits.

Localisation mode (`activate_localization_mode`) tracks against a frozen
map: no keyframe is inserted, and a depth sensor's close unmatched
keypoints of the last frame help as temporary VO points.  `save_map` /
`load_map` checkpoint the map in the JAX package's npz format.

The default vocabulary is the package's `data/vocab_default.npz`, as the
JAX package loads its own; without a vocabulary file the session has no
BoW, relocalisation or loop closing.
"""

from __future__ import annotations

import functools
import os
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.ba import local as ba_local
from orb_slam2_tpu_torch.ba.async_gba import AsyncGBA
from orb_slam2_tpu_torch.config import MONOCULAR, RGBD, STEREO, SLAMConfig
from orb_slam2_tpu_torch.core import control, lie, spans
from orb_slam2_tpu_torch.map import checkpoint, ops
from orb_slam2_tpu_torch.map.state import (MapState, empty_map, first_flagged,
                                           one_or_many, seq_ids, seq_put_row_,
                                           seq_where)
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import init as init_mod
from orb_slam2_tpu_torch.pipeline import loopclosing, mapping, reloc, tracking
from orb_slam2_tpu_torch.pipeline.frame import Frame
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_LEN, HUD_N_KF,
                                                   HUD_NEED_KF, HUD_REF_KF,
                                                   HUD_STATUS, LOST,
                                                   NOT_INITIALIZED, OK,
                                                   TrackState, record_traj)
from orb_slam2_tpu_torch.place import bow_cuda
from orb_slam2_tpu_torch.place.vocab import Vocabulary, build_transform
from orb_slam2_tpu_torch.solvers import twoview
from orb_slam2_tpu_torch.viz.viewer import render_frame

BA_ITERS = 5
DEFAULT_VOCAB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "vocab_default.npz")


@one_or_many
def set_bow(state: MapState, kf, bow: torch.Tensor, on) -> MapState:
    """Keyframe kf[s]'s BoW vector bow [S, W], for the sequences where
    on [S] holds (all where it is None), written into the table in place
    (at the reference's 10^6 words a copy of the table is GBs)."""
    k = seq_ids(kf, state.kf_bow.shape[0], bow.device)
    seq_put_row_(state.kf_bow, k, bow, on)
    return state


def n_stages(cfg: SLAMConfig) -> int:
    """Integration stages per keyframe: triangulate, fuse, the BA chunks
    (5 LM iterations each, damping carried across), culls."""
    total_ba = cfg.ba.local_ba_iters1 + cfg.ba.local_ba_iters2
    return 2 + max(-(-total_ba // BA_ITERS), 1) + 1


# Batched calls of the insertion and of each stage group, summed on the
# device in place (so also under graph replay): one a call whatever the
# number of sequences it serves; `int(c)` reads one, `c.reset()` restarts
# it.
insert_calls = control.Count()
STAGE_GROUPS = ("triangulate", "fuse", "local_ba", "cull")
stage_calls = {g: control.Count() for g in STAGE_GROUPS}


@one_or_many
def insert_kf(state: MapState, ts: TrackState, frame, cur_pids,
              cfg: SLAMConfig, active=None):
    """Insert each sequence's tracked frame (a Frame with a leading [S]
    axis) as a keyframe, with its depth points for stereo/RGB-D, and arm
    its integration; one call for all S.  `active` [S]: the sequences
    whose depth points the counts take (all by default; the caller keeps
    the others' state)."""
    insert_calls.tick(ts.T.device)
    state, kf_id = ops.insert_keyframe(state, frame, ts.T, cur_pids)
    if cfg.sensor != MONOCULAR:
        state = mapping.create_depth_points(state, kf_id, cfg, active)
    S = kf_id.shape[0]
    dev = ts.T.device
    k = kf_id.to(torch.int32)
    ts = ts._replace(
        ref_kf=k, last_kf_frame_id=seq_ids(frame.frame_id, S, dev).to(
            torch.int32),
        map_kf=k, map_stage=torch.zeros(S, dtype=torch.int32, device=dev),
        ba_lam=torch.full((S,), 1e-4, device=dev))
    return state, record_traj(state, ts, frame, True)


def on_sequences(on: torch.Tensor, fn, operands):
    """`fn(*operands, on)` for the sequences where on [S] holds, each of
    the others keeping its own values.  With n of them, fn runs on a dense
    batch of the next power of two >= n sequences (the sequences gathered,
    the results scattered back; all S once that reaches S), under a device
    branch on n, so that a stage group serving few of the sequences does
    little of the others' work.  At S = 1, fn itself: the caller's branch
    runs it only when its one sequence takes it."""
    S = on.shape[0]
    if S == 1:
        return fn(*operands, on)
    n = on.sum()
    lo, A = 0, 1
    while True:
        A = min(A, S)
        hit = n > lo if A == S else (n > lo) & (n <= A)
        operands = control.cond(hit, functools.partial(_dense, on, fn, A),
                                control.identity, operands)
        if A == S:
            return operands
        lo, A = A, 2 * A


def _dense(on, fn, A, *ops):
    """`on_sequences`'s branch for a batch of A of the S sequences."""
    if A == on.shape[0]:
        return seq_where(on, fn(*ops, on), ops)
    idx = first_flagged(on, A)                  # the n, then others
    keep = on.gather(0, idx)
    take = lambda x: x.index_select(0, idx) if isinstance(
        x, torch.Tensor) else x
    sub = pytree.tree_map(take, ops)
    # a field fn wrote in place (a BoW row) goes back too
    version = {id(x): x._version for x in pytree.tree_leaves(sub)
               if isinstance(x, torch.Tensor)}
    new = seq_where(keep, fn(*sub, keep), sub)
    put = lambda x, m, s: x if m is s and (
        not isinstance(s, torch.Tensor) or s._version == version[id(s)]
    ) else x.index_copy(0, idx, m)
    return pytree.tree_map(put, ops, new, sub)


@one_or_many
def mapping_stage(state: MapState, ts: TrackState, cfg: SLAMConfig,
                  n_st: Optional[int] = None):
    """Advance each sequence's pending keyframe integration by one stage,
    of `n_st` (by default `n_stages(cfg)`); sequences with none pending
    (`map_kf < 0`) keep theirs.  JAX switches on the stage (system.py:
    150-153), and under the dp step's vmap that switch selects: here each
    distinct stage function (triangulate, fuse, a BA chunk, cull) runs
    once for the sequences at that stage under a device branch on "some
    sequence is at it" (`on_sequences`), each sequence keeping its own
    stage's result; the BA chunks share one call, each sequence with its
    own damping."""
    n_st = n_st or n_stages(cfg)
    active = ts.map_kf >= 0
    stage = ts.map_stage
    kf = lambda t: t.map_kf.long().clamp(min=0)

    def s_tri(st, t, on):
        return mapping.triangulate_new_points(st, kf(t), cfg), t

    def s_fuse(st, t, on):
        return mapping.fuse_neighbors(st, kf(t), cfg), t

    def s_ba(st, t, on):
        st, lam = ba_local.local_ba(st, kf(t), cfg, n_outer=BA_ITERS,
                                    lam0=t.ba_lam, return_lam=True)
        return st, t._replace(ba_lam=lam)

    def s_cull(st, t, on):
        st = mapping.cull_points(st, kf(t), cfg)
        return mapping.cull_redundant_keyframes(st, t, kf(t), cfg, active=on)

    groups = zip(STAGE_GROUPS, (s_tri, s_fuse, s_ba, s_cull),
                 (stage <= 0, stage == 1, (stage >= 2) & (stage < n_st - 1),
                  stage >= n_st - 1))
    for name, fn, at in groups:
        on = active & at

        def run(st, t, name=name, fn=fn, on=on):
            stage_calls[name].tick(on.device)
            return on_sequences(on, fn, (st, t))

        state, ts = control.cond(on.any(), run, control.identity,
                                 (state, ts))
    nxt = ts.map_stage + 1
    done = nxt >= n_st
    ts = ts._replace(
        map_stage=torch.where(active, torch.where(done, 0, nxt),
                              ts.map_stage).to(torch.int32),
        map_kf=torch.where(active & done, -1, ts.map_kf).to(torch.int32))
    return state, ts


def build_frame_fn(cfg: SLAMConfig, device=None):
    """The sensor's frame function, (*images, frame_id, timestamp) ->
    Frame: (image) mono, (image, depth map) RGB-D, (left, right) stereo."""
    if cfg.sensor == MONOCULAR:
        return frame_mod.build_mono_frame_fn(cfg, device)
    if cfg.sensor == RGBD:
        return frame_mod.build_rgbd_frame_fn(cfg, device)
    if cfg.sensor == STEREO:
        return frame_mod.build_stereo_frame_fn(cfg, device)
    raise ValueError(f"unknown sensor {cfg.sensor}")


def build_full_step(cfg: SLAMConfig, device=None, transform=None,
                    frame_fn=None):
    """Returns the per-frame step

        (state, ts, imgs, frame_id, timestamp, loc_only=False)
            -> (state, ts, frame, hud [6])

    with `imgs` the tuple of the sensor's images: frame construction
    (`frame_fn`, by default the sensor's) -> tracking -> keyframe decision
    -> conditional insertion (with the keyframe's BoW vector when
    `transform`, the vocabulary transform, is given) -> one integration
    stage (JAX `full_step`, system.py:203-232), every decision a device
    branch.  In localization mode (`loc_only`, a Python bool) nothing is
    inserted.  Runs on `device`: CUDA unless the caller names one."""
    frame_fn = frame_fn or build_frame_fn(cfg, device)
    track_step = tracking.build_track_step(cfg)

    def full_step(state, ts, imgs, frame_id, timestamp, loc_only=False):
        frame = frame_fn(*imgs, frame_id, timestamp)
        state, ts, cur_pids, hud = track_step(state, ts, frame, loc_only)
        # while the previous KF's triangulation/fusion stages are pending,
        # defer; once only BA/cull stages remain, a new insertion aborts
        # them (reference LocalMapping::InsertKeyFrame / mbAbortBA)
        busy_early = (ts.map_kf >= 0) & (ts.map_stage <= 1)
        need = (hud[HUD_NEED_KF] > 0) & ~busy_early
        if loc_only:
            need = torch.zeros_like(need)
        else:
            def do_kf(st, t):
                st, t = insert_kf(st, t, frame, cur_pids, cfg)
                if transform is not None:
                    st = set_bow(st, t.ref_kf,
                                 transform(frame.desc, frame.valid)[0],
                                 None)
                return st, t

            state, ts = control.cond(need, do_kf, control.identity,
                                     (state, ts))
        state, ts = control.cond(
            ts.map_kf >= 0, lambda st, t: mapping_stage(st, t, cfg),
            control.identity, (state, ts))
        hud = torch.cat([hud[:HUD_NEED_KF], need.to(torch.int32).reshape(1),
                         hud[HUD_NEED_KF + 1:],
                         ts.ref_kf.reshape(1).to(torch.int32)])
        return state, ts, frame, hud

    return full_step


def assign(dst: NamedTuple, src: NamedTuple):
    """Copy every field of `src` whose tensor is not `dst`'s own into
    `dst`'s storage (the session's fixed buffers keep their addresses)."""
    for d, v in zip(dst, src):
        if v is not d:
            d.copy_(v)


def assign_fields(dst: NamedTuple, **fields):
    """Write the named fields of `dst` in place (tensors or scalars)."""
    for name, v in fields.items():
        t = getattr(dst, name)
        if isinstance(v, torch.Tensor):
            t.copy_(v)
        else:
            t.fill_(v)


def empty_frames(cfg: SLAMConfig, n: int, device) -> Frame:
    """A ring of `n` frames (every field with a leading [n])."""
    N = cfg.orb.max_keypoints
    z = lambda *shape, dt=torch.float32: torch.zeros((n,) + shape, dtype=dt,
                                                     device=device)
    return Frame(uv=z(N, 2), uv_raw=z(N, 2), ur=z(N), depth=z(N),
                 octave=z(N, dt=torch.int32), angle=z(N),
                 desc=z(N, 32, dt=torch.uint8), valid=z(N, dt=torch.bool),
                 frame_id=z(dt=torch.int32), timestamp=z())


def clone(t: NamedTuple):
    """A copy of every field of `t`."""
    return type(t)(*[x.clone() for x in t])


class SLAM:
    """One SLAM session; `cfg.sensor` picks the camera.  Usage:

        slam = SLAM(cfg)                    # CUDA; device="cpu" to opt out
        for img, t in sequence:
            slam.track_mono(img, t)         # or track_stereo(left, right, t)
        slam.save_trajectory_tum("traj.txt")    # or track_rgbd(img, depth, t)

    On CUDA the per-frame step is captured as a CUDA graph and replayed;
    `capture=False` runs it eagerly instead (comparisons, phase timers).
    """

    def __init__(self, cfg: SLAMConfig, device=None, seed: int = 0,
                 vocab_path: Optional[str] = None,
                 enable_loop_closing: bool = True,
                 capture: Optional[bool] = None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        cuda = dev.type == "cuda"
        if capture and not cuda:
            raise ValueError("a CUDA graph needs a CUDA device")
        self.capture = cuda if capture is None else capture
        # the fixed buffers: the graph reads and writes them in place
        self._state = empty_map(cfg, dev)
        self._ts = tracking.empty_track_state(cfg, dev)
        self.frame_count = 0
        self.status = NOT_INITIALIZED
        self.last_hud = np.zeros(HUD_LEN, np.int32)
        self.timings: List[float] = []
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.enable_loop = enable_loop_closing
        self.last_loop_kf = -100
        self.localization_only = False
        self.hud_lag = 8
        self._pending: deque = deque()     # (frame_id, hud slot, b, event,
        #                                     ring slot)
        # (frame_id, kf_id, (ids, groups), event, the HUD entry's frame id)
        self._loop_pending: deque = deque()
        self._reloc_pending = None           # (frame_id, reloc out, Frame)
        self._batch: list = []               # (imgs, frame_id, timestamp)
        self._last_big_change = 0
        self._last_img = None                # for draw_current_frame
        self._gba_cause = None               # the frame that started it

        # the program's inputs and outputs: B image slots per sensor image,
        # frame ids, timestamps and active flags; the HUD of each slot; the
        # ring of tracked frames kept for relocalisation
        B = cfg.frame_batch
        n_img = 1 if cfg.sensor == MONOCULAR else 2
        H, W = cfg.camera.height, cfg.camera.width
        self._ring = empty_frames(cfg, self.hud_lag + B + 1, dev)
        self._hud = torch.zeros((B, HUD_LEN), dtype=torch.int32, device=dev)
        self._in_imgs = tuple(torch.zeros((B, H, W), device=dev)
                              for _ in range(n_img))
        self._in_fid = torch.zeros(B, dtype=torch.int32, device=dev)
        self._in_t = torch.zeros(B, device=dev)
        self._in_act = torch.zeros(B, dtype=torch.bool, device=dev)
        # host side: a ring of staging slots (pinned on CUDA), one a
        # dispatch, each with two timing events (made once): before its
        # input copies and after its HUD copy
        Q = self.hud_lag + 2
        pin = dict(pin_memory=cuda)
        self._pin_imgs = tuple(torch.zeros((Q, B, H, W), **pin)
                               for _ in range(n_img))
        self._pin_fid = torch.zeros((Q, B), dtype=torch.int32, **pin)
        self._pin_t = torch.zeros((Q, B), **pin)
        self._pin_act = torch.zeros((Q, B), dtype=torch.bool, **pin)
        self._pin_hud = torch.zeros((Q, B, HUD_LEN), dtype=torch.int32,
                                    **pin)
        self._slot_event: list = [None] * Q   # recorded slots' end events
        self._slot_start = [torch.cuda.Event(enable_timing=True)
                            if cuda else None for _ in range(Q)]
        self._slot_end = [torch.cuda.Event(enable_timing=True)
                          if cuda else None for _ in range(Q)]
        self._n_dispatch = 0
        self.frames_stepped = 0              # frames run by the program
        self._graphs: dict = {}              # loc_only -> CUDAGraph
        self.graph_replays = 0

        # vocabulary: the reference loads ORBvoc.txt at startup
        # (System.cc:62); the package ships a trained default
        path = vocab_path or DEFAULT_VOCAB
        self.vocab = Vocabulary.load(path) if os.path.exists(path) else None
        self._transform = None
        if self.vocab is not None:
            self._transform = build_transform(
                self.vocab, pad_to=cfg.vocab.branching ** cfg.vocab.depth,
                device=dev)
            if dev.type == "cuda":
                # detection's scoring kernel: built here, in set-up, and
                # not at the first keyframe's detection
                bow_cuda.load()
            self._reloc_step = reloc.build_reloc_step(cfg, self._transform)
            self._consistency = loopclosing.ConsistencyTracker(
                cfg.loop.covisibility_consistency_th)
        self._gba = AsyncGBA(cfg)
        self._frame_fn = build_frame_fn(cfg, dev)
        self._full_step = build_full_step(cfg, dev, self._transform,
                                          self._frame_fn)

    # the map and track state: fixed storage; assigning copies into it
    @property
    def state(self) -> MapState:
        return self._state

    @state.setter
    def state(self, new: MapState):
        assign(self._state, new)

    @property
    def ts(self) -> TrackState:
        return self._ts

    @ts.setter
    def ts(self, new: TrackState):
        assign(self._ts, new)

    def __del__(self):
        # free the graphs' memory pools with the session (not at exit,
        # when the modules are gone)
        if control is not None:
            for g in getattr(self, "_graphs", {}).values():
                control.release(g)

    # ------------------------------------------------------------------
    def track_mono(self, img: np.ndarray, timestamp: float):
        self._last_img = img
        self._track(MONOCULAR, (img,), timestamp)

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray,
                   timestamp: float):
        """`depth`: the registered depth map in metres (0 = none)."""
        self._last_img = img
        self._track(RGBD, (img, depth), timestamp)

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                     timestamp: float):
        """A rectified pair."""
        self._last_img = img_l
        self._track(STEREO, (img_l, img_r), timestamp)

    def _track(self, sensor: int, imgs, timestamp: float):
        if sensor != self.cfg.sensor:
            raise ValueError(f"a sensor-{sensor} frame given to a session "
                             f"configured for sensor {self.cfg.sensor}")
        shape = (self.cfg.camera.height, self.cfg.camera.width)
        for a in imgs:
            if tuple(np.shape(a)) != shape:
                raise ValueError(f"an image of shape {np.shape(a)} given to "
                                 f"a session configured for {shape}")
        fid = self.frame_count
        with spans.span("frame", fid) as frame_span:
            if self.status == NOT_INITIALIZED:
                with self.host_reaction(), spans.span("init", fid,
                                                      self.device):
                    frame = self._frame_fn(*(torch.as_tensor(
                        np.asarray(a, np.float32), device=self.device)
                        for a in imgs), fid, timestamp)
                    self._initialize(frame)
                self.frame_count += 1
            else:
                self._batch.append((imgs, fid, timestamp))
                self.frame_count += 1
                if len(self._batch) >= self.cfg.frame_batch:
                    self._dispatch_batch()
                self._drain(self.hud_lag)
        self.timings.append(frame_span.dur)

    def host_reaction(self):
        """A host reaction between frames (initialisation, reset,
        relocalisation, loop closing, the global BA, flush): it may read
        the device, so CUDA's sync debug mode is off inside it."""
        return control.sync_allowed(self.device)

    # ------------------------------------------------------------------
    # the program: B step bodies over the fixed buffers
    def _program(self, loc_only: bool, state, ts, ring, hud):
        """Run the buffered inputs' B slots through the per-frame step
        (JAX `super_step`, system.py:237-279: a slot runs under a device
        branch on its `active` flag); each slot's frame goes into `ring`
        at its frame id's slot and its HUD into `hud`.  Returns the final
        (state, ts)."""
        B = self.cfg.frame_batch
        R = ring.frame_id.shape[0]
        for b in range(B):
            imgs = tuple(x[b] for x in self._in_imgs)
            fid, t = self._in_fid[b], self._in_t[b]

            def run(st, tt, b=b, imgs=imgs, fid=fid, t=t):
                st, tt, frame, h = self._full_step(st, tt, imgs, fid, t,
                                                   loc_only)
                slot = (fid.long() % R).reshape(1)
                for r, f in zip(ring, frame):
                    r.index_copy_(0, slot, f.to(r.dtype).unsqueeze(0))
                hud[b].copy_(h)
                return st, tt

            if B == 1:
                state, ts = run(state, ts)
            else:
                state, ts = control.cond(self._in_act[b], run,
                                         control.identity, (state, ts))
        return state, ts

    def _run_program(self, loc_only: bool):
        """The program on the session's own buffers: eagerly, or as the
        captured graph's replay."""
        if not self.capture:
            with spans.span("replay"):
                st, tt = self._program(loc_only, self._state, self._ts,
                                       self._ring, self._hud)
                assign(self._state, st)
                assign(self._ts, tt)
            return
        g = self._graphs.get(loc_only)
        if g is None:
            with spans.span("capture"):
                g = self._graphs[loc_only] = self._capture_program(loc_only)
        with spans.span("replay"):
            g.replay()
        self.graph_replays += 1

    def _capture_program(self, loc_only: bool) -> torch.cuda.CUDAGraph:
        """The program captured on the session's buffers, its state
        written back in place (`control.capture_program`: warmed up on
        copies first; a failure raises)."""
        def run(on_copies: bool):
            if on_copies:
                self._program(loc_only, clone(self._state), clone(self._ts),
                              clone(self._ring), self._hud.clone())
                return
            st, tt = self._program(loc_only, self._state, self._ts,
                                   self._ring, self._hud)
            assign(self._state, st)
            assign(self._ts, tt)

        return control.capture_program(run, self.device)

    def _dispatch_batch(self):
        """Run the buffered frames as one program (JAX's scanned
        super-step, system.py:237-281); a partial batch (flush) runs with
        its trailing slots inactive.  The inputs go through the next
        staging slot; the batch's HUD entries join the queue after it, to
        be read `hud_lag` frames later."""
        entries, self._batch = self._batch, []
        if not entries:
            return
        with spans.span("dispatch", entries[0][1]):
            B = self.cfg.frame_batch
            Q = len(self._slot_event)
            q = self._n_dispatch % Q
            self._n_dispatch += 1
            self.frames_stepped += len(entries)
            if self._slot_event[q] is not None:
                with spans.span("slot_wait"):    # the slot's copies are done
                    self._slot_event[q].synchronize()
                spans.waited(self._slot_event[q])
            for b in range(B):
                imgs, fid, t = entries[min(b, len(entries) - 1)]
                for pin, a in zip(self._pin_imgs, imgs):
                    pin[q, b].copy_(torch.as_tensor(a))
                self._pin_fid[q, b] = fid
                self._pin_t[q, b] = t
                self._pin_act[q, b] = b < len(entries)
            blocking = self.device.type != "cuda"
            # the stream looked up once for both events (a host cost)
            stream = None if blocking else torch.cuda.current_stream(
                self.device)
            start = spans.mark(self.device, self._slot_start[q], stream)
            for x, pin in zip(self._in_imgs + (self._in_fid, self._in_t,
                                               self._in_act),
                              self._pin_imgs + (self._pin_fid, self._pin_t,
                                                self._pin_act)):
                x.copy_(pin[q], non_blocking=not blocking)
            self._run_program(self.localization_only)
            self._pin_hud[q].copy_(self._hud, non_blocking=not blocking)
            ev = None
            if not blocking:
                ev = self._slot_end[q]
                ev.record(stream)
                spans.interval("dispatch", entries[0][1], start, ev)
            self._slot_event[q] = ev
            R = self._ring.frame_id.shape[0]
            for b, (_, fid, _) in enumerate(entries):
                self._pending.append((fid, q, b, ev, fid % R))

    def _ring_frame(self, slot: int) -> Frame:
        return Frame(*[f[slot] for f in self._ring])

    # ------------------------------------------------------------------
    def flush(self):
        """Process pending HUD entries, finish the staged integration of
        the last keyframe and any running global BA.  Call before reading
        trajectories or counters."""
        with spans.span("flush", self.frame_count - 1):
            if self._batch:
                self._dispatch_batch()
            self._drain(0)
            with self.host_reaction():
                with spans.span("stages", device=self.device):
                    for _ in range(16):
                        if int(self.ts.map_kf) < 0:
                            break
                        self.state, self.ts = mapping_stage(
                            self.state, self.ts, self.cfg)
                self._step_gba(to_completion=True)
                if self.device.type == "cuda":
                    with spans.span("sync"):
                        torch.cuda.synchronize(self.device)
                    spans.synced(self.device)

    def _drain(self, keep: int):
        """React to HUD entries older than `keep` frames: lost within the
        first 5 keyframes -> reset (reference Tracking.cc:472-480); lost
        later -> relocalise; a new keyframe -> schedule loop detection."""
        with spans.span("drain"):
            while len(self._pending) > keep:
                fid, q, b, ev, slot = self._pending.popleft()
                if ev is not None:
                    with spans.span("hud_wait", fid):
                        ev.synchronize()
                    spans.waited(ev)
                hud = self._pin_hud[q, b].numpy().copy()
                self.last_hud = hud
                self.status = int(hud[HUD_STATUS])
                if self.status == OK:
                    if hud[HUD_NEED_KF]:
                        spans.count("drained_keyframe")
                        if self.enable_loop and \
                                self._transform is not None:
                            self._schedule_loop_detect(
                                int(hud[HUD_REF_KF]), fid)
                else:
                    if int(hud[HUD_N_KF]) <= 5:
                        with self.host_reaction():
                            self.reset(cause=fid)
                        return
                    if self._transform is not None and \
                            self._reloc_pending is None:
                        with self.host_reaction(), spans.span(
                                "reloc_launch", fid, self.device):
                            # a copy: the ring slot is reused R frames
                            # later
                            frame = clone(self._ring_frame(slot))
                            self._reloc_pending = (
                                fid, self._run_reloc(frame), frame)
            self._check_reloc(force=(keep == 0))
            self._check_loops(force=(keep == 0))
            self._step_gba()

    def _run_reloc(self, frame):
        u = torch.rand((reloc.N_CAND, reloc.PNP_ITERS, reloc.PNP_SAMPLE),
                       generator=self.gen, device=self.device)
        return self._reloc_step(self.state, frame, u)

    def _step_gba(self, to_completion: bool = False):
        """Advance the chunked post-loop global BA by one chunk; fold the
        result into the live map when its budget is spent
        (LoopClosing.cc:645-749)."""
        if not self._gba.active:
            return
        with self.host_reaction(), spans.span("gba", self._gba_cause,
                                              self.device):
            while True:
                if self._gba.step():
                    self.state, T_new = self._gba.merge(self.state, self.ts.T,
                                                        self.ts.ref_kf)
                    assign_fields(self.ts, T=T_new, last_T=T_new,
                                  has_velocity=False)
                    return
                if not to_completion:
                    return

    # ------------------------------------------------------------------
    def _check_reloc(self, force: bool = False):
        """Apply a pending relocalisation once it is `hud_lag` frames old
        (reference Tracking::Relocalization, Tracking.cc:1341-1502)."""
        if self._reloc_pending is None:
            return
        fid, (ok, T, pids, cand), frame = self._reloc_pending
        if not force and self.frame_count - fid < self.hud_lag:
            return
        self._reloc_pending = None
        with self.host_reaction(), spans.span("reloc_apply", fid,
                                              self.device):
            if not bool(ok):
                return
            spans.count("relocalised")
            assign_fields(
                self.ts, status=OK, T=T, last_T=T, has_velocity=False,
                last_pids=pids, last_uv=frame.uv, last_octave=frame.octave,
                last_angle=frame.angle, last_valid=frame.valid,
                last_desc=frame.desc, last_depth=frame.depth, ref_kf=cand,
                last_reloc_frame_id=frame.frame_id)
            self.ts = record_traj(self.state, self.ts, frame, True)
        self.status = OK

    def _relocalize(self, frame) -> bool:
        """Synchronous relocalisation (diagnostics); the session's own path
        goes through _drain / _check_reloc."""
        self._reloc_pending = (self.frame_count, self._run_reloc(frame), frame)
        self._check_reloc(force=True)
        return self.status == OK

    # ------------------------------------------------------------------
    def _schedule_loop_detect(self, kf_id: int, cause: int):
        """Loop-candidate detection for a fresh keyframe (made by frame
        `cause`); its result is consumed `hud_lag` frames later by
        _check_loops (reference LoopClosing::Run, LoopClosing.cc:57-88)."""
        if kf_id - self.last_loop_kf < self.cfg.loop.min_kfs_since_last:
            return  # LoopClosing.cc:114
        with spans.span("detect_launch", cause):
            start = spans.mark(self.device)
            ids, groups = loopclosing.detect(self.state, kf_id, self.cfg)
            # to the host asynchronously, as the HUD: read when consumed,
            # so the detection stalls nothing
            cuda = self.device.type == "cuda"
            host = tuple(torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=cuda)
                         for x in (ids, groups))
            for h, x in zip(host, (ids, groups)):
                h.copy_(x, non_blocking=cuda)
            ev = None
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans.interval("detect_launch", cause, start, ev)
        self._loop_pending.append((self.frame_count, kf_id, host, ev,
                                   cause))

    def _check_loops(self, force: bool = False):
        """Consume ripe loop detections: temporal consistency, then Sim3
        verification and loop correction (rare)."""
        while self._loop_pending:
            fid, kf_id, (ids, groups), ev, cause = self._loop_pending[0]
            if not force and self.frame_count - fid < self.hud_lag:
                return
            self._loop_pending.popleft()
            if ev is not None:
                with spans.span("loop_wait", cause):
                    ev.synchronize()
                spans.waited(ev)
            self._verify_loop(kf_id, ids.numpy(), groups.numpy(), cause)

    def _verify_loop(self, kf_id: int, ids: np.ndarray, groups: np.ndarray,
                     cause: Optional[int] = None):
        """Temporal consistency of a detection's candidates (ids [C],
        groups [C, K] on the host), then Sim3 verification and correction
        of the consistent ones (a host reaction; `cause`: the frame whose
        keyframe was the query)."""
        if (ids < 0).all():
            self._consistency.reset()
            return
        consistent = self._consistency.update(ids, groups)
        if consistent:
            with self.host_reaction():
                self._correct_loop(kf_id, consistent, cause)

    def _correct_loop(self, kf_id: int, consistent, cause=None):
        for cand in consistent[:2]:
            with spans.span("verify", cause, self.device):
                u = torch.rand((loopclosing.SIM3_ITERS, 3),
                               generator=self.gen, device=self.device)
                ok, Scm, loop_pids, _ = loopclosing.verify(
                    self.state, kf_id, cand, u, self.cfg)
                ok = bool(ok)
            if ok:
                with spans.span("correct", cause, self.device):
                    self.state = loopclosing.correct(
                        self.state, kf_id, cand, Scm, loop_pids, self.cfg)
                    T_new = self.state.kf_pose[kf_id]
                    assign_fields(self.ts, T=T_new, last_T=T_new,
                                  has_velocity=False)
                    # GBA after the pose graph, chunked between frames; a
                    # new loop discards a running solve (LoopClosing.cc:
                    # 411-423, 576-579)
                    self._gba.start(self.state, self.cfg.ba.loop_gba_iters)
                    self._gba_cause = cause
                self.last_loop_kf = kf_id
                self._consistency.reset()
                break

    # ------------------------------------------------------------------
    def _initialize(self, frame):
        cfg = self.cfg
        if cfg.sensor != MONOCULAR:
            # one frame with enough keypoints with depth (Tracking.cc:509)
            if int(frame.n) >= cfg.tracking.stereo_init_min_kps:
                state, ts, _ = init_mod.stereo_initialize(
                    self.state, self.ts, frame, cfg)
                ts = record_traj(state, ts, frame, True)
                if self._transform is not None:
                    state = set_bow(state, ts.ref_kf.long(),
                                    self._transform(frame.desc,
                                                    frame.valid)[0], None)
                self.state, self.ts = state, ts
                self.status = OK
            return
        if not bool(self.ts.init_valid_frame):
            self.ts = init_mod.store_init_frame(self.ts, frame)
            return
        if int(frame.n) <= cfg.tracking.min_init_kps:
            assign_fields(self.ts, init_valid_frame=False)
            return
        match = init_mod.match_for_init(self.ts, frame, cfg)
        if int(match.n) < cfg.tracking.min_init_matches:
            self.ts = init_mod.store_init_frame(self.ts, frame)
            return
        sets = twoview.sample_sets(self.gen, match.idx >= 0,
                                   cfg.init.ransac_iters)
        state, ts, ok = init_mod.create_mono_map(self.state, self.ts, frame,
                                                 match.idx, sets, cfg)
        if bool(ok):
            init_desc = ts.init_desc.clone()
            init_valid = ts.init_kp_valid.clone()
            # refine the fresh two-KF map with a global BA (Tracking.cc:686)
            k1 = int(state.next_kf) - 1
            state = ba_local.global_ba(state, cfg,
                                       n_outer=cfg.ba.global_ba_iters,
                                       n_cg=40)
            T1 = state.kf_pose[k1]
            ts = ts._replace(T=T1, last_T=T1)
            ts = record_traj(state, ts, frame, True)
            if self._transform is not None:
                state = set_bow(state, k1 - 1, self._transform(
                    init_desc, init_valid)[0], None)
                state = set_bow(state, k1, self._transform(
                    frame.desc, frame.valid)[0], None)
            self.state, self.ts = state, ts
            self.status = OK
        # on failure keep the stored first frame and retry with the next

    def activate_localization_mode(self):
        """Reference System::ActivateLocalizationMode (System.cc:270): track
        against the frozen map, no keyframe insertion or mapping."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self, cause: Optional[int] = None):
        """Reference System/Tracking::Reset (`cause`: the frame whose HUD
        entry called for it, for the span log)."""
        with spans.span("reset", cause, self.device):
            self.state = empty_map(self.cfg, self.device)
            self.ts = tracking.empty_track_state(self.cfg, self.device)
            self.status = NOT_INITIALIZED
            self._gba.cancel()
            self._batch.clear()

    # ------------------------------------------------------------------
    def _traj_arrays(self):
        """Frame poses rebuilt as Tcr x (final optimized) reference-KF pose
        (reference System::SaveTrajectoryTUM)."""
        self.flush()
        traj = self.ts.traj
        ref = traj[:, 14].to(torch.int64).clamp(min=0)
        Tcw = lie.se3_compose(traj[:, 7:14], self.state.kf_pose[ref])
        Twc = lie.se3_inverse(Tcw)
        Tcw, Twc = Tcw.cpu().numpy(), Twc.cpu().numpy()
        traj = traj.cpu().numpy()
        ok = (traj[:, 15] > 0.5) & (traj[:, 14] >= 0)
        ok[self.frame_count:] = False
        t = traj[:, 16]
        return [(t[i], Tcw[i], Twc[i]) for i in np.nonzero(ok)[0]]

    def poses_twc(self) -> np.ndarray:
        recs = self._traj_arrays()
        if not recs:
            return np.zeros((0, 7))
        return np.stack([r[2] for r in recs])

    def timestamps(self) -> np.ndarray:
        return np.asarray([r[0] for r in self._traj_arrays()])

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as f:
            for t, _Tcw, Twc in self._traj_arrays():
                qw, qx, qy, qz, tx, ty, tz = Twc
                f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """Reference System::SaveKeyFrameTrajectoryTUM (System.cc:383-417):
        one TUM-format line per live keyframe, ordered by id."""
        self.flush()
        valid = self.state.kf_valid.cpu().numpy()
        tstamp = self.state.kf_timestamp.cpu().numpy()
        Twc = lie.se3_inverse(self.state.kf_pose).cpu().numpy()
        with open(path, "w") as f:
            for k in np.nonzero(valid)[0]:
                qw, qx, qy, qz, tx, ty, tz = Twc[k]
                f.write(f"{tstamp[k]:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: per-frame 3x4 row-major Twc matrix (reference
        System::SaveTrajectoryKITTI, System.cc:419-472)."""
        with open(path, "w") as f:
            for _t, _Tcw, Twc in self._traj_arrays():
                m = np.concatenate([_rot(Twc[:4]), Twc[4:7, None]], axis=1)
                f.write(" ".join(f"{v:.6e}" for v in m.reshape(-1)) + "\n")

    # ------------------------------------------------------------------
    # map checkpoint / resume
    def save_map(self, path: str):
        """Checkpoint the full map to a compressed npz (the JAX package's
        format, map/checkpoint.py)."""
        self.flush()
        checkpoint.save_map(self.state, path)

    def load_map(self, path: str):
        """Load a prebuilt map onto the session's device and arm tracking
        against it: status LOST with keyframe 0 as the reference, so the
        next frame tries the reference keyframe and then relocalisation
        (pair with activate_localization_mode() for pure localization).
        A map of at most 5 keyframes resets on the first lost frame, as
        any young map does."""
        self.state = checkpoint.load_map(path, self.device)
        self.ts = tracking.empty_track_state(self.cfg, self.device)
        assign_fields(self.ts, status=LOST, ref_kf=0)
        self.status = LOST
        self._pending.clear()
        self._loop_pending.clear()
        self._reloc_pending = None
        self._gba.cancel()

    # ------------------------------------------------------------------
    # observability (reference System.cc:474-490)
    def get_tracking_state(self) -> int:
        """Reference System::GetTrackingState (the host's view, HUD-late)."""
        return self.status

    def get_tracked_map_points(self) -> np.ndarray:
        """Per-keypoint map-point id of the last tracked frame (-1 = none),
        the array form of System::GetTrackedMapPoints."""
        self.flush()
        return self.ts.last_pids.cpu().numpy()

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints [N, 2] of the last tracked frame and their
        validity mask [N] (System::GetTrackedKeyPointsUn)."""
        self.flush()
        return self.ts.last_uv.cpu().numpy(), self.ts.last_valid.cpu().numpy()

    def draw_current_frame(self, out_path: str) -> str:
        """Render the last tracked frame with its keypoint overlay and
        status bar to a PNG (reference FrameDrawer::DrawFrame,
        FrameDrawer.cc:38-165); returns out_path."""
        self.flush()
        img = self._last_img
        if img is None:
            img = np.zeros((self.cfg.camera.height, self.cfg.camera.width))
        return render_frame(
            img, self.ts.last_uv, self.ts.last_valid, self.ts.last_pids,
            self.status, int(self.state.n_kf), int(self.state.n_mp),
            out_path, loc_only=self.localization_only)

    def map_changed(self) -> bool:
        """Reference System::MapChanged (System.cc:282-293): whether the
        big-change counter (loop correction, global BA) moved since the
        last call."""
        with self.host_reaction():
            idx = int(self.state.big_change)
        changed = idx != self._last_big_change
        self._last_big_change = idx
        return changed


def _rot(q) -> np.ndarray:
    """3x3 rotation of a unit quaternion (w, x, y, z)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
