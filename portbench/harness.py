"""Drive the program through one cell: set-up, the measured window, the
traced extras, and the outputs the check judges.

Two modes, chosen by the traffic file's "mode":

- "session": one `SLAM` session (`pipeline/system.py`), fed in a closed
  loop from host memory as a recording is replayed.  "passes" plays the
  sequence from its first frame each pass, then `flush()`, and `reset()`
  before the next (the captured graph is kept); "pingpong" plays it
  forward, then backward, and so on, with no reset (localisation on the
  map that set-up built: the motion stays continuous).  `warm_after`
  frames of the play order run in set-up; a pass that they start is
  checked whole, from its first frame.
- "dp": `distributed/dp.py` `DPProgram`, S sequences stepped together,
  their frames resident on the card; each step plays the next frame of
  the ping-pong order.

The window starts on an idle card and ends after the last frame's
`flush()` (dp: the last step) and a synchronisation.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import render, trace, vocab, window

SENSORS = {"mono": 0, "stereo": 1, "rgbd": 2}
GROUPS = ("camera", "orb", "match", "tracking", "init", "mapping", "loop",
          "pnp", "ba", "cap")


def slam_config(conf: dict):
    """The program's SLAMConfig from a configuration file: its defaults,
    with each group's keys replaced by the file's."""
    from orb_slam2_tpu_torch import config as C
    cfg = C.SLAMConfig(sensor=SENSORS[conf["sensor"]])
    groups = {k: dataclasses.replace(getattr(cfg, k), **conf[k])
              for k in GROUPS if k in conf}
    depth = conf.get("vocabulary", {}).get("depth")
    if depth is not None:
        groups["vocab"] = dataclasses.replace(cfg.vocab, depth=depth)
    return cfg.replace(**groups)


def camera(conf: dict) -> render.Camera:
    names = {f.name for f in dataclasses.fields(render.Camera)}
    return render.Camera(**{k: v for k, v in conf["camera"].items()
                            if k in names})


def pingpong(k: int, n: int) -> int:
    """Frame index of play position k over n frames played forward,
    backward, forward, ... (the turning frames played once)."""
    period = 2 * (n - 1)
    r = k % period
    return r if r < n else period - r


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    attempted: int = 0
    timings_ms: List[float] = dataclasses.field(default_factory=list)
    step_ms: List[float] = dataclasses.field(default_factory=list)
    flush_s: float = 0.0       # the closing flush and synchronisation


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class Player:
    """Feeds one session frame by frame in the traffic's order, and keeps,
    at each pass's end, the outputs the check judges (the trajectory's
    rows of the pass and the keyframe poses, copied on the card)."""

    def __init__(self, slam, seq: render.Sequence, host: dict, play: str,
                 frames: int):
        self.slam, self.seq, self.host, self.play = slam, seq, host, play
        self.reset_due = False
        self.last_idx = 0
        self.map_first = None           # the frame that started the map
        from orb_slam2_tpu_torch.pipeline.tracking import NOT_INITIALIZED
        self._not_init = NOT_INITIALIZED
        self.n = frames                 # frames a pass
        self.R = host["images"].shape[0] // frames
        self.pos = 0                   # position in the play order
        self.pass_fid0 = slam.frame_count
        self.window_fid0 = slam.frame_count    # the window's first frame
        self.pass_idx: List[int] = []  # frame index of each fid of the pass
        self.passes: List[dict] = []
        self.fid_idx: Dict[int, int] = {}
        sensor = slam.cfg.sensor
        if sensor == SENSORS["rgbd"]:
            self._feed = lambda i, t: slam.track_rgbd(
                host["images"][i], host["depth"][i], t)
        elif sensor == SENSORS["stereo"]:
            self._feed = lambda i, t: slam.track_stereo(
                host["images"][i], host["right"][i], t)
        else:
            raise ValueError("the session cells play stereo or RGB-D")

    def _index(self) -> int:
        """Passes play the recordings in turn, each from its first frame;
        ping-pong plays the first recording forward and back."""
        if self.play == "passes":
            k = self.pos // self.n
            return (k % self.R) * self.n + self.pos % self.n
        return pingpong(self.pos, self.n)

    def step(self):
        """Feed the next frame; at the end of a pass, close it (and reset
        before the next frame)."""
        if self.reset_due:
            self.slam.reset()
            self.reset_due = False
        i = self.last_idx = self._index()
        if self.slam.status == self._not_init:
            self.map_first = i
        fid = self.slam.frame_count
        t = (fid - self.pass_fid0 if self.play == "passes" else fid
             ) / self.seq.fps
        self._feed(i, t)
        self.fid_idx[fid] = i
        self.pass_idx.append(i)
        self.pos += 1
        at_end = (self.pos % self.n == 0 if self.play == "passes" else
                  self.pos % (self.n - 1) == 0)
        if at_end:
            self.close_pass()
            self.reset_due = self.play == "passes"

    def close_pass(self):
        slam = self.slam
        if self.play == "passes":
            slam.flush()
        f0, f1 = self.pass_fid0, slam.frame_count
        if f1 > f0:
            self.passes.append({
                "fid0": f0, "window_row": max(0, self.window_fid0 - f0),
                "idx": np.asarray(self.pass_idx),
                "traj": slam.ts.traj[f0:f1].clone(),
                "kf_pose": slam.state.kf_pose.clone()})
        self.pass_idx = []
        self.pass_fid0 = slam.frame_count

    def finish(self):
        """Close the open pass (flush, no reset): the window's end."""
        self.slam.flush()
        if self.pass_idx:
            self.close_pass()


def texture_seed(traffic: dict, seed: int, stream: int) -> int:
    """The textures' seed of recording (dp: sequence) `stream`: from the
    traffic's fixed `texture_seed` when it has one, else from the run's
    seed."""
    return render.torch_seed(traffic.get("texture_seed", seed), 100 + stream)


def render_host(conf: dict, traffic: dict, seed: int, device) -> tuple:
    """The traffic's recordings (`recordings`, default 1; recording r's
    noise from the seed's stream r, its textures from `texture_seed`),
    rendered on the card and kept in host memory one after the other:
    images [R F, H, W] and the ground truth [R F, 7]."""
    cam = camera(conf)
    sensor = conf["sensor"]
    seqs = [render.render_sequence(
        cam, traffic["trajectory"], traffic["frames"],
        render.torch_seed(seed, 100 + r), stereo=sensor == "stereo",
        with_depth=sensor == "rgbd", device=device, out_device="cpu",
        depth_range=traffic.get("depth_range", render.DEPTH_RANGE),
        motion=traffic.get("motion"),
        texture_seed=texture_seed(traffic, seed, r))
        for r in range(traffic.get("recordings", 1))]
    cat = lambda xs: np.concatenate([x.numpy() for x in xs])
    host = {"images": cat([q.images for q in seqs])}
    if seqs[0].right is not None:
        host["right"] = cat([q.right for q in seqs])
    if seqs[0].depth is not None:
        host["depth"] = cat([q.depth for q in seqs])
    seq = dataclasses.replace(seqs[0], images=None, right=None, depth=None,
                              twc=np.concatenate([q.twc for q in seqs]))
    return seq, host


class Session:
    """One session cell: `setup`, `window`, then the traced extras and
    `outputs`."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device,
                 loop: bool = True):
        from orb_slam2_tpu_torch.pipeline.system import SLAM
        self.conf, self.traffic = conf, traffic
        self.cfg = slam_config(conf)
        self.device = torch.device(device)
        self.seq, self.host = render_host(conf, traffic, seed, self.device)
        # the span log's position: the session's loop corrections are the
        # `correct` spans after it
        log = window.program_log()
        self.log_from = None if log is None else (
            log.seq, log.totals.get("correct", [0])[0])
        self.slam = SLAM(self.cfg, device=self.device,
                         vocab_path=vocab.path_for(conf["vocabulary"]),
                         enable_loop_closing=loop,
                         capture=self.device.type == "cuda")

    def setup(self):
        """Warm up every shape the window uses: the capture at the first
        tracked frame, a keyframe's stages, (passes) a reset and the next
        initialisation, (localisation) the mapping pass that builds the
        map and the localisation graph."""
        tr, slam = self.traffic, self.slam
        if tr.get("localize"):
            F = tr["frames"]
            build = Player(slam, self.seq, self.host, "passes", F)
            for _ in range(F):
                build.step()
            self.map_pass = build.passes[0]
            self.map_first = build.map_first
            slam.activate_localization_mode()
            self.player = Player(slam, self.seq, self.host, "pingpong", F)
            self.player.pos = F - 1
        else:
            warm = Player(slam, self.seq, self.host, "passes", tr["frames"])
            for _ in range(tr["warm_frames"]):
                warm.step()
            slam.flush()
            slam.reset()
            self.player = Player(slam, self.seq, self.host, tr["play"],
                                 tr["frames"])
            self.map_first = None
        p = self.player
        for _ in range(tr.get("warm_after", 0)):
            p.step()
        p.passes.clear()
        if p.play != "passes":
            p.pass_idx = []
            p.pass_fid0 = slam.frame_count
            p.fid_idx.clear()
        p.window_fid0 = slam.frame_count
        sync()

    def window(self, seconds: float, events: bool) -> Window:
        """The measured window (`events` has no use here: the session's
        per-layer times come from the traced extras)."""
        slam, p = self.slam, self.player
        n_t0 = len(slam.timings)
        w = Window()
        sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            p.step()
            w.attempted += 1
        t1 = time.perf_counter()
        p.finish()
        sync()
        w.seconds = time.perf_counter() - t0
        w.flush_s = t0 + w.seconds - t1
        w.timings_ms = [x * 1e3 for x in slam.timings[n_t0:]]
        return w

    # -- traced extras (after the window; nothing after the profiler) --
    def stage_times(self, reps: int) -> Dict[str, float]:
        """Device ms (CUDA events around `reps` calls, after one warm
        call) of the eager step's parts on the warm final state
        (bench.stage_times' pattern): frame construction, the tracking
        step, a keyframe's insertion with all its integration stages, and
        one loop detection over the session's keyframe table."""
        from orb_slam2_tpu_torch.pipeline import loopclosing, system, tracking
        slam, cfg, dev = self.slam, self.cfg, self.device
        i = self.player.last_idx
        first = torch.as_tensor(self.host["images"][i], device=dev).float()
        second = torch.as_tensor(self.host["right" if "right" in self.host
                                           else "depth"][i],
                                 device=dev).float()
        fid, t = slam.frame_count, 0.0
        track = tracking.build_track_step(cfg)

        def timed(fn):
            fn()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            sync()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            sync()
            return a.elapsed_time(b) / reps

        frame = slam._frame_fn(first, second, fid, t)

        def keyframe():
            st, ts, cur_pids, _ = track(slam.state, slam.ts, frame)
            st, ts = system.insert_kf(st, ts, frame, cur_pids, cfg)
            for _ in range(system.n_stages(cfg)):
                st, ts = system.mapping_stage(st, ts, cfg)

        out = {"extract_ms": timed(lambda: slam._frame_fn(
                   first, second, fid, t)),
               "track_ms": timed(lambda: track(slam.state, slam.ts, frame))}
        if not slam.localization_only:
            out["keyframe_ms"] = timed(keyframe)
            if slam.vocab is not None:
                valid = slam.state.kf_valid.nonzero()
                if len(valid):
                    kf = int(valid[-1])
                    out["detect_ms"] = timed(lambda: loopclosing.detect(
                        slam.state, kf, cfg))
        return out

    def profiled(self, frames: int):
        p = self.player

        def run():
            for _ in range(frames):
                p.step()
            self.slam.flush()
        t0 = time.perf_counter()
        prof = trace.profile(run)
        return prof, time.perf_counter() - t0, frames

    def fast_images(self) -> int:
        return 2 if self.cfg.sensor == SENSORS["stereo"] else 1

    def outputs(self, rng: np.random.RandomState, n_kf: int) -> dict:
        """What the timed path produced, on the host: each pass's
        trajectory rows and keyframe poses; the final map's points;
        sampled keyframes' keypoints, descriptors and BoW rows; the ring's
        frames (the window's last frames)."""
        slam, p = self.slam, self.player
        if self.map_first is None:
            self.map_first = p.map_first
        passes = [{"fid0": q["fid0"], "window_row": q["window_row"],
                   "idx": q["idx"],
                   "traj": q["traj"].cpu().numpy(),
                   "kf_pose": q["kf_pose"].cpu().numpy()} for q in p.passes]
        st = slam.state
        kf_ok = np.nonzero(st.kf_valid.cpu().numpy())[0]
        fids = st.kf_frame_id.cpu().numpy()
        fid_idx = dict(p.fid_idx)
        map_idx = None
        if self.traffic.get("localize"):
            base = self.map_pass
            map_idx = {base["fid0"] + j: int(i)
                       for j, i in enumerate(base["idx"])}
        lookup = map_idx if map_idx is not None else fid_idx
        kf_ok = np.asarray([k for k in kf_ok if int(fids[k]) in lookup])
        take = kf_ok
        if len(kf_ok) > n_kf:
            take = np.sort(np.concatenate([
                kf_ok[-1:], rng.choice(kf_ok[:-1], n_kf - 1, replace=False)]))
        kfs = {"idx": np.asarray([lookup[int(fids[k])] for k in take],
                                 np.int64)}
        for name in ("kf_uv", "kf_octave", "kf_desc", "kf_kp_valid"):
            kfs[name] = getattr(st, name)[torch.as_tensor(
                take, dtype=torch.long, device=self.device)].cpu().numpy()
        table = None
        if slam.vocab is not None:
            table = self.place_table(take)
        mp = st.mp_pos[st.mp_valid].cpu().numpy()
        ring = slam._ring
        rf = ring.frame_id.cpu().numpy()
        keep = [r for r in range(len(rf)) if int(rf[r]) in fid_idx]
        ring_out = {"idx": np.asarray([fid_idx[int(rf[r])] for r in keep],
                                      np.int64)}
        for name in ("uv_raw", "octave", "desc", "valid"):
            ring_out[name] = getattr(ring, name)[keep].cpu().numpy()
        n_kf_live = int(st.kf_valid.sum())
        n_mp_live = int(st.mp_valid.sum())
        out = {"passes": passes, "keyframes": kfs, "points": [mp],
               "ring": ring_out, "table": table,
               "map_first_idx": [self.map_first],
               "fill": {"keyframes": n_kf_live, "points": n_mp_live},
               "corrections": self.corrections()}
        return out

    def corrections(self) -> Optional[List[int]]:
        """The frame (the span's cause: the frame whose keyframe found the
        loop) of each loop correction the session made, from the program's
        span log (its `correct` spans); None without a log, or when the log
        has dropped some of them."""
        log = window.program_log()
        if log is None or self.log_from is None:
            return None
        seq0, calls0 = self.log_from
        got = sorted(s[1] for s in log.spans
                     if s[0] == "correct" and s[5] > seq0)
        calls = log.totals.get("correct", [0])[0] - calls0
        return got if len(got) == calls else None

    def place_table(self, queries) -> dict:
        """Place recognition's outputs over the final map: every live
        keyframe's BoW row (its nonzero words) and descriptors, the
        covisibility weights, and the program's loop detection
        (`loopclosing.detect`, the entry the session calls on each new
        keyframe) for each query keyframe: its candidates' ids and their
        accumulated scores (`database.detect_loop_candidates`' result,
        kept as `detect` returns it)."""
        from orb_slam2_tpu_torch.pipeline import loopclosing
        from orb_slam2_tpu_torch.place import database
        st, cfg = self.slam.state, self.cfg
        valid = st.kf_valid.cpu().numpy()
        rows, desc = [None] * len(valid), [None] * len(valid)
        for k in np.nonzero(valid)[0]:
            row = st.kf_bow[int(k)]
            w = torch.nonzero(row > 0).flatten()
            rows[k] = (w.cpu().numpy().astype(np.int64),
                       row[w].double().cpu().numpy())
            desc[k] = st.kf_desc[int(k)][st.kf_kp_valid[int(k)]].cpu().numpy()
        real, got = database.detect_loop_candidates, []

        def kept(*a, **kw):
            got.append(real(*a, **kw))
            return got[-1]
        detect = {}
        database.detect_loop_candidates = kept
        try:
            for q in queries:
                ids, _ = loopclosing.detect(st, int(q), cfg)
                ids = ids.cpu().numpy()
                sc = got.pop().scores.cpu().numpy()
                detect[int(q)] = {int(i): float(v)
                                  for i, v in zip(ids, sc) if i >= 0}
        finally:
            database.detect_loop_candidates = real
        return {"valid": valid, "covis": st.covis.cpu().numpy(),
                "rows": rows, "desc": desc, "detect": detect}

    def close(self):
        self.slam = None
        self.player = None
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dp step
# ---------------------------------------------------------------------------

class Fleet:
    """S sequences stepped together by one `DPProgram`."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from orb_slam2_tpu_torch.distributed import dp
        self.dp = dp
        self.conf, self.traffic = conf, traffic
        self.cfg = slam_config(conf)
        self.device = torch.device(device)
        S, F = traffic["sequences"], traffic["frames"]
        cam = camera(conf)
        seqs = [render.render_sequence(
            cam, traffic["trajectory"], F, seed * S + s, stereo=False,
            with_depth=True, device=self.device,
            depth_range=traffic.get("depth_range", render.DEPTH_RANGE),
            motion=traffic.get("motion"),
            texture_seed=texture_seed(traffic, seed, s))
            for s in range(S)]
        self.images = torch.stack([q.images for q in seqs])     # [S, F, H, W]
        self.depth = torch.stack([q.depth for q in seqs])
        self.seqs = [dataclasses.replace(q, images=None, depth=None)
                     for q in seqs]
        del seqs
        self.S, self.F, self.fps = S, F, cam.fps
        self.prog = dp.DPProgram(self.cfg, S, self.device,
                                 capture=self.device.type == "cuda")
        self.k = 0

    def _step(self, prog=None):
        prog = prog or self.prog
        self.k += 1
        i = pingpong(self.k, self.F)
        prog.step(self.images[:, i], self.depth[:, i], self.k,
                  self.k / self.fps)

    def setup(self):
        self.prog.init(self.images[:, 0], self.depth[:, 0])
        for _ in range(self.traffic["warm_steps"]):
            self._step()
        sync()

    def window(self, seconds: float, events: bool) -> Window:
        w = Window()
        ev = []
        sync()
        t0 = time.perf_counter()
        if events:
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[0].record()
        k0 = self.k
        while time.perf_counter() - t0 < seconds:
            h0 = time.perf_counter()
            self._step()
            w.timings_ms.append((time.perf_counter() - h0) * 1e3)
            if events:
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
        t1 = time.perf_counter()
        sync()
        w.seconds = time.perf_counter() - t0
        w.flush_s = t0 + w.seconds - t1
        w.attempted = (self.k - k0) * self.S
        self.window_steps = (k0 + 1, self.k + 1)
        w.step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        return w

    def profiled(self, steps: int):
        def run():
            for _ in range(steps):
                self._step()
        t0 = time.perf_counter()
        prof = trace.profile(run)
        return prof, time.perf_counter() - t0, steps * self.S

    def phases(self, steps: int) -> Dict[str, float]:
        """Device ms a step charged to the step's `dp.PHASE` ranges, from
        an eager program on a copy of the warm state, each step under a
        trace of its own (`charge`)."""
        dp = self.dp
        eager = dp.DPProgram(self.cfg, self.S, self.device, capture=False)
        eager.state = self.prog.state
        eager.ts = self.prog.ts
        tot: Dict[str, float] = {}
        for _ in range(steps):
            prof = trace.profile(lambda: self._step(eager))
            for k, (us, _) in trace.charge(prof, dp.PHASE, (
                    "extract", "track", "insert", "stage")).items():
                tot[k] = tot.get(k, 0.0) + us / 1e3
        del eager
        return {k: v / steps for k, v in tot.items()}

    def fast_images(self) -> int:
        return self.S

    def outputs(self, rng: np.random.RandomState, n_kf: int) -> dict:
        prog = self.prog
        st, ts = prog.state, prog.ts
        n_rows = self.k + 1
        out = {"passes": [], "keyframes": [], "points": [], "ring": None,
               "map_first_idx": [], "fill": {"keyframes": 0, "points": 0}}
        idx_of = np.asarray([pingpong(k, self.F) for k in range(n_rows)])
        traj = ts.traj[:, :n_rows].cpu().numpy()
        kf_pose = st.kf_pose.cpu().numpy()
        kf_valid = st.kf_valid.cpu().numpy()
        kf_fid = st.kf_frame_id.cpu().numpy()
        per = max(1, n_kf // self.S)
        for s in range(self.S):
            out["passes"].append({"fid0": 0, "idx": idx_of,
                                  "traj": traj[s], "kf_pose": kf_pose[s],
                                  "seq": s})
            ok = np.nonzero(kf_valid[s])[0]
            take = ok
            if len(ok) > per:
                take = np.sort(np.concatenate([
                    ok[-1:], rng.choice(ok[:-1], per - 1, replace=False)]))
            kfs = {"idx": idx_of[np.clip(kf_fid[s][take], 0, n_rows - 1)],
                   "seq": s}
            sel = torch.as_tensor(take, dtype=torch.long, device=self.device)
            for name in ("kf_uv", "kf_octave", "kf_desc", "kf_kp_valid"):
                kfs[name] = getattr(st, name)[s][sel].cpu().numpy()
            out["keyframes"].append(kfs)
            out["points"].append(st.mp_pos[s][st.mp_valid[s]].cpu().numpy())
            out["map_first_idx"].append(0)
            out["fill"]["keyframes"] = max(out["fill"]["keyframes"],
                                           int(kf_valid[s].sum()))
            out["fill"]["points"] = max(out["fill"]["points"],
                                        int(st.mp_valid[s].sum()))
        return out

    def close(self):
        self.prog = None
        gc.collect()
        torch.cuda.empty_cache()


def build(conf: dict, traffic: dict, seed: int, device, loop: bool = True):
    """The cell's `Session` or `Fleet`; `loop` False turns the session's
    loop closing off (a control: the dp program closes no loops)."""
    if traffic["mode"] == "session":
        return Session(conf, traffic, seed, device, loop)
    if traffic["mode"] == "dp":
        return Fleet(conf, traffic, seed, device)
    raise ValueError(f"unknown traffic mode {traffic['mode']!r}")
