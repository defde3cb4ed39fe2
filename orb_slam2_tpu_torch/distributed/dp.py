"""Data-parallel multi-sequence SLAM: S independent RGB-D sequences, one
map each, stepped in lock-step (port of orb_slam2_tpu/distributed/dp.py).

The JAX package vmaps its per-frame program over a leading sequence axis.
Here the states are the same NamedTuples with a leading [S] axis on every
field; one step extracts the S images in one batched atlas program (one
FAST launch over S·L planes), then tracks, decides on a keyframe, inserts
it and runs one mapping stage for each sequence in turn, and stacks the
results into new tensors (a field that no sequence changed keeps its
tensor).  The per-sequence part reads the host, as the session's step
does, so it is not yet one device program.

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

import torch
import torch.distributed as dist

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.config import RGBD, SLAMConfig
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.map.state import MapState, empty_map
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import init as init_mod
from orb_slam2_tpu_torch.pipeline import system, tracking
from orb_slam2_tpu_torch.pipeline.tracking import (HUD_NEED_KF, TrackState,
                                                   record_traj)

BA_CHUNKS = 3
BA_ITERS = system.BA_ITERS      # 5: each chunk's LM iterations
N_STAGES = 2 + BA_CHUNKS + 1

# names of the communication events in a torch.profiler trace
_COMM_PREFIXES = ("c10d::", "gloo:", "nccl", "record_param_comms")
_COLLECTIVES = ("allreduce", "allgather", "reducescatter", "broadcast",
                "alltoall", "send", "recv")


def _take(tree, s: int):
    """Sequence s of a stacked NamedTuple (views)."""
    return type(tree)(*(x[s] for x in tree))


def _restack(stacked, views, outs):
    """New stacked NamedTuple from the per-sequence results `outs`; a field
    that every sequence returned untouched (its input view) keeps the
    stacked tensor."""
    fields = []
    for i, old in enumerate(stacked):
        vals = [o[i] for o in outs]
        if all(v is w[i] for v, w in zip(vals, views)):
            fields.append(old)
        else:
            fields.append(torch.stack(vals))
    return type(stacked)(*fields)


def _each_sequence(state, ts, fn):
    """fn(s, state_s, ts_s) -> (state_s, ts_s, out) for every sequence s in
    turn; returns the new stacked (state, ts) and the outs."""
    views = [(_take(state, s), _take(ts, s)) for s in range(ts.T.shape[0])]
    res = [fn(s, st, t) for s, (st, t) in enumerate(views)]
    return (_restack(state, [v[0] for v in views], [r[0] for r in res]),
            _restack(ts, [v[1] for v in views], [r[1] for r in res]),
            [r[2] for r in res])


def build_dp_step(cfg: SLAMConfig, device=None):
    """Returns (init_fn, step_fn) over stacked states, on `device` (CUDA
    unless the caller names one):

        init_fn(state, ts, img [S, H, W], depth [S, H, W]) -> (state, ts)
        step_fn(state, ts, img, depth, fid [S], t [S])
            -> (state, ts, hud [S, 5])

    The step is the session's per-frame program (tracking + the staged
    LocalMapping) minus the host-driven rare events (loop closing,
    relocalisation), which are not on the throughput path."""
    if cfg.sensor != RGBD:
        raise ValueError("the DP driver batches RGB-D sequences")
    dev = resolve_device(device)
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

    def init_fn(state, ts, img, depth):
        S = img.shape[0]
        fr = frames(img, depth, torch.zeros(S, dtype=torch.int32),
                    torch.zeros(S, dtype=torch.float32))

        def one(s, st, t):
            frame = _take(fr, s)
            if int(frame.n) >= cfg.tracking.stereo_init_min_kps:
                st, t, _ = init_mod.stereo_initialize(st, t, frame, cfg)
                t = record_traj(st, t, frame, True)
            return st, t, None

        state, ts, _ = _each_sequence(state, ts, one)
        return state, ts

    def step_fn(state, ts, img, depth, fid, t):
        fr = frames(img, depth, fid, t)

        def one(s, st, tt):
            frame = _take(fr, s)
            st, tt, cur_pids, hud = track(st, tt, frame)
            busy_early = int(tt.map_kf) >= 0 and int(tt.map_stage) <= 1
            if bool(hud[HUD_NEED_KF]) and not busy_early:
                st, tt = system.insert_kf(st, tt, frame, cur_pids, cfg)
            if int(tt.map_kf) >= 0:
                st, tt = system.mapping_stage(st, tt, cfg, N_STAGES)
            return st, tt, hud

        state, ts, huds = _each_sequence(state, ts, one)
        return state, ts, torch.stack(huds)

    return init_fn, step_fn


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
    stacked tree (tensors, NamedTuples, tuples, lists), CUDA tensors moved
    to the rank's current card."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def shard(x):
        if torch.is_tensor(x):
            S = x.shape[0]
            x = x[r * S // n:(r + 1) * S // n]
            return x.to(torch.cuda.current_device()) if x.is_cuda else x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(shard, x))
        return type(x)(map(shard, x))

    return shard(tree)


def build_sharded_step(cfg: SLAMConfig, group, device=None):
    """The rank's (init, step) over its shard of the sequences
    (`shard_batch(..., group)`): `build_dp_step` on the rank's device.  The
    sequence axis is embarrassingly parallel, so the step issues no
    collective (`collective_ops_in_trace` of a profiled step is 0)."""
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
