"""Run the sharded solvers over N processes on this machine (the port's
counterpart of scripts/launch_multihost.py).

    python -m orb_slam2_tpu_torch.distributed.launch --nprocs 2 \\
        --backend gloo [--device cpu]

spawns N ranks with torch.multiprocessing, each with SLAM_COORDINATOR /
SLAM_NUM_PROCS / SLAM_PROC_ID set so that `init_multihost` joins them,
and runs one landmark-sharded BA (8 cameras x 1024 points, point-major)
over all of them; every rank prints a checksum of its replicated cameras,
which must agree.  The ranks run on the CUDA cards, taken in turn, unless
`--device cpu` is given; without a card and without `--device cpu` the
launch raises.  Two ranks on one card need `--backend gloo` (NCCL refuses
two ranks on a device).

`spawn` and `solve_worker` are the pieces the tests and chip_smoke.py
use: `solve_worker` runs a list of jobs (observation-sharded BA,
landmark-sharded BA, pose graph; problems as numpy fields or a map
checkpoint) and writes each rank's results to an npz.  The synthetic
problems are the JAX tests' recipes, rebuilt on the port's `core/lie.py`
from the same numpy seeds.
"""

from __future__ import annotations

import argparse
import multiprocessing.connection
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from orb_slam2_tpu_torch import convert, resolve_device
from orb_slam2_tpu_torch.ba import local as ba_local
from orb_slam2_tpu_torch.core import camera, lie
from orb_slam2_tpu_torch.distributed.ba import (distributed_ba_solve,
                                                distributed_ba_solve_sharded)
from orb_slam2_tpu_torch.distributed.posegraph import distributed_pose_graph
from orb_slam2_tpu_torch.distributed.runtime import (global_pt_mesh,
                                                     init_multihost)
from orb_slam2_tpu_torch.map import checkpoint

# every rank must have ended by then; a hung rendezvous is killed
RANK_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(target, rank: int, nprocs: int, port: int, args) -> None:
    os.environ.update(SLAM_COORDINATOR=f"127.0.0.1:{port}",
                      SLAM_NUM_PROCS=str(nprocs), SLAM_PROC_ID=str(rank))
    # every rank is on this machine: gloo talks over the loopback device
    # (its default looks the host name up, which a machine without a
    # network may not resolve)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    target(rank, nprocs, *args)


def spawn(target, nprocs: int, args=(), timeout: float = RANK_TIMEOUT_S):
    """Run `target(rank, nprocs, *args)` in `nprocs` fresh processes.
    Raises when a rank exits non-zero (the others are then killed) or when
    any is still running after `timeout` seconds (all are killed)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(target, r, nprocs, port, args),
                         daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            alive = [p for p in procs if p.is_alive()]
            if not alive or any(p.exitcode not in (None, 0) for p in procs):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{len(alive)} of {nprocs} ranks still "
                                   f"running after {timeout} s")
            multiprocessing.connection.wait([p.sentinel for p in alive],
                                            timeout=left)
        codes = [p.exitcode for p in procs]
        if codes != [0] * nprocs:
            raise RuntimeError(f"rank exit codes: {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


# ---------------------------------------------------------------------------
# synthetic problems (numpy fields, as convert.py takes them)
# ---------------------------------------------------------------------------

BA_K = (500.0, 500.0, 320.0, 240.0)
BA_BF = 40.0


def make_ba_problem(n_cams: int = 6, n_pts: int = 120, noise_px: float = 0.5,
                    pose_noise: float = 0.05, pt_noise: float = 0.05,
                    stereo: bool = False, seed: int = 0):
    """tests/test_ba.py's `_make_problem`: cameras along x looking at a
    cloud 6 m ahead, every camera seeing every point (camera-major rows),
    camera 0 fixed at the truth, the rest and the points perturbed.
    Returns (fields, poses_gt [C, 7], points_gt [M, 3])."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    K = f32(BA_K)
    pts_gt = f32(rng.randn(n_pts, 3) * [2.5, 2.5, 1.0] + [0, 0, 6])
    poses = []
    for c in range(n_cams):
        t = f32([0.3 * c - 0.75, 0.05 * rng.randn(), 0.02 * c])
        xi = f32(np.concatenate([[0, 0, 0], rng.randn(3) * 0.02]))
        poses.append(lie.se3_compose(lie.se3_exp(xi),
                                     lie.se3_from_Rt(torch.eye(3), -t)))
    poses_gt = torch.stack(poses)
    uvs, urs = [], []
    for c in range(n_cams):
        pc = lie.se3_apply(poses_gt[c], pts_gt)
        uv = camera.project(K, pc) + f32(rng.randn(n_pts, 2) * noise_px)
        uvs.append(uv)
        urs.append(camera.stereo_right_u(K, BA_BF, uv, pc[:, 2]) if stereo
                   else torch.full((n_pts,), -1.0))
    cam_noise = f32(np.concatenate([np.zeros((1, 6)),
                                    rng.randn(n_cams - 1, 6) * pose_noise]))
    pts_init = pts_gt + f32(rng.randn(n_pts, 3) * pt_noise)
    n = lambda a: a.numpy()
    fields = dict(
        cam_pose=n(lie.se3_retract(poses_gt, cam_noise)),
        cam_var=np.array([False] + [True] * (n_cams - 1)),
        points=n(pts_init), pt_var=np.ones(n_pts, bool),
        obs_cam=np.repeat(np.arange(n_cams, dtype=np.int32), n_pts),
        obs_pid=np.tile(np.arange(n_pts, dtype=np.int32), n_cams),
        obs_uv=n(torch.cat(uvs)), obs_ur=n(torch.cat(urs)),
        obs_w=np.ones(n_cams * n_pts, np.float32),
        K=np.asarray(BA_K, np.float32), bf=np.float32(BA_BF))
    return fields, n(poses_gt), n(pts_gt)


def to_point_major(fields, n_cams: int, n_pts: int):
    """A full-grid camera-major problem (row c*P + p) reordered point-major
    (row p*C + c): D = n_cams observer slots per point."""
    perm = (np.arange(n_cams)[None, :] * n_pts +
            np.arange(n_pts)[:, None]).reshape(-1)
    out = dict(fields)
    for f in ("obs_cam", "obs_pid", "obs_uv", "obs_ur", "obs_w"):
        out[f] = fields[f][perm]
    return out


def make_ring_problem(n: int = 12, drift: float = 0.03, seed: int = 0,
                      fix_scale: bool = False):
    """tests/test_posegraph.py's `_ring_problem`: poses on a circle, exact
    odometry edges, estimates chained through drifting odometry, one loop
    edge n-1 -> 0, node 0 fixed.  Returns (fields, gt [n, 8])."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        q = lie.so3_exp(f32([0.0, ang, 0.0]))
        t = f32([np.cos(ang) * 3, 0.0, np.sin(ang) * 3])
        gt.append(lie.sim3_from_se3(lie.se3(q, t)))
    gt = torch.stack(gt)
    est = [gt[0]]
    ei, ej, meas = [], [], []
    for i in range(n - 1):
        S_meas = lie.sim3_compose(gt[i + 1], lie.sim3_inverse(gt[i]))
        ei.append(i)
        ej.append(i + 1)
        meas.append(S_meas)
        noise = f32(np.concatenate([rng.randn(3) * drift,
                                    rng.randn(3) * drift * 0.5,
                                    [0.0 if fix_scale else
                                     rng.randn() * drift * 0.3]]))
        S_odo = lie.sim3_compose(lie.sim3_exp(noise), S_meas)
        est.append(lie.sim3_compose(S_odo, est[-1]))
    ei.append(n - 1)
    ej.append(0)
    meas.append(lie.sim3_compose(gt[0], lie.sim3_inverse(gt[n - 1])))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    fields = dict(nodes=torch.stack(est).numpy(), node_valid=np.ones(n, bool),
                  node_fixed=fixed, edge_i=np.asarray(ei, np.int32),
                  edge_j=np.asarray(ej, np.int32),
                  edge_meas=torch.stack(meas).numpy(),
                  edge_w=np.ones(len(ei), np.float32),
                  fix_scale=np.asarray(fix_scale))
    return fields, gt.numpy()


def multihost_problem(C: int = 8, P: int = 1024):
    """scripts/launch_multihost.py's problem: C cameras 0.15 m apart on x,
    P points 4 m ahead, mono, point-major (row p*C + c)."""
    rng = np.random.RandomState(0)
    K = (200.0, 200.0, 64.0, 48.0)
    Kt = torch.tensor(K)
    pts = torch.as_tensor(rng.randn(P, 3) * [1, 1, 0.3] + [0, 0, 4],
                          dtype=torch.float32)
    cams, uvs = [], []
    for c in range(C):
        T = lie.se3_from_Rt(torch.eye(3), torch.tensor([-0.15 * c, 0.0, 0.0]))
        cams.append(T)
        uvs.append(camera.project(Kt, lie.se3_apply(T, pts)) + torch.as_tensor(
            rng.randn(P, 2) * 0.3, dtype=torch.float32))
    pts_init = pts + torch.as_tensor(rng.randn(P, 3) * 0.02,
                                     dtype=torch.float32)
    return dict(
        cam_pose=torch.stack(cams).numpy(),
        cam_var=np.array([False] + [True] * (C - 1)),
        points=pts_init.numpy(), pt_var=np.ones(P, bool),
        obs_cam=np.tile(np.arange(C, dtype=np.int32), P),
        obs_pid=np.repeat(np.arange(P, dtype=np.int32), C),
        obs_uv=torch.stack(uvs, 1).reshape(-1, 2).numpy(),
        obs_ur=np.full(P * C, -1.0, np.float32),
        obs_w=np.ones(P * C, np.float32),
        K=np.asarray(K, np.float32), bf=np.float32(0.0))


# ---------------------------------------------------------------------------
# the rank's work
# ---------------------------------------------------------------------------

def _problem(job, device):
    if job["kind"] == "pg":
        return convert.pose_graph_problem_from_numpy(job["problem"], device)
    if "map" in job:
        state = checkpoint.load_map(job["map"], device)
        return ba_local.build_global_problem_point_major(state, job["cfg"])
    return convert.ba_problem_from_numpy(job["problem"], device)


def _solve(job, prob, group):
    """One sharded solve; its outputs as {name: tensor}."""
    kw = dict(n_outer=job["n_outer"], n_cg=job["n_cg"])
    if job["kind"] == "pg":
        nodes, costs = distributed_pose_graph(prob, group, **kw)
        return {"nodes": nodes, "costs": costs}
    if job["kind"] == "obs":
        res = distributed_ba_solve(prob, group, **kw)
    else:
        res = distributed_ba_solve_sharded(prob, group, D=job["D"], **kw)
    return res._asdict()


def _collective_clock(sync, log):
    """`dist.all_reduce` timed (device synchronised on both sides) into
    `log`: a solve's collective count and ms, at the price of a sync."""
    inner = dist.all_reduce

    def timed(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        sync()
        log.append(time.perf_counter() - t0)
        return out

    return timed


def solve_worker(rank: int, nprocs: int, jobs, out_dir: str,
                 device: str | None = None, backend: str = "gloo",
                 repeats: int = 1, clock_collectives: bool = False) -> None:
    """Join the group (`init_multihost` from the SLAM_* env vars), run
    each job `repeats` times, and write `rank{r}.npz` into `out_dir`:
    `{job}.{output}.{i}` for repeat i and `{job}.ms`, the wall time of
    each repeat (device synchronised); with `clock_collectives`, also
    `{job}.allreduce_ms`, the time of each all-reduce of one more solve
    with every collective timed; `timeline`, the epoch seconds at which
    the rank started work, joined the group and ended each job.  `device`
    None: the CUDA cards (`resolve_device`: raises without one)."""
    timeline = [time.time()]
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init_multihost(backend=backend)
    timeline.append(time.time())
    assert dist.get_world_size() == nprocs, dist.get_world_size()
    group = global_pt_mesh()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {}
    try:
        for job in jobs:
            prob = _problem(job, dev)
            ms = []
            for i in range(repeats):
                dist.barrier(group)
                sync()
                t0 = time.perf_counter()
                res = _solve(job, prob, group)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                for k, v in res.items():
                    out[f"{job['name']}.{k}.{i}"] = v.detach().cpu().numpy()
            out[f"{job['name']}.ms"] = np.asarray(ms)
            if clock_collectives:
                log, inner = [], dist.all_reduce
                dist.all_reduce = _collective_clock(sync, log)
                try:
                    _solve(job, prob, group)
                finally:
                    dist.all_reduce = inner
                out[f"{job['name']}.allreduce_ms"] = np.asarray(log) * 1e3
            timeline.append(time.time())
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 timeline=np.asarray(timeline), **out)
    finally:
        dist.destroy_process_group()


def _print_checksum(rank: int, nprocs: int, device: str, backend: str):
    with tempfile.TemporaryDirectory() as tmp:
        solve_worker(rank, nprocs, [dict(
            name="pt", kind="pt", problem=multihost_problem(), D=8,
            n_outer=4, n_cg=10)], tmp, device, backend)
        cam = np.load(os.path.join(tmp, f"rank{rank}.npz"))["pt.cam_pose.0"]
    print(f"[rank {rank}] landmark-sharded BA over {nprocs} ranks ({backend}"
          f", {device}) OK, cam checksum {float(np.sum(cam)):.6f}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA cards)")
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S)
    args = ap.parse_args(argv)
    # resolved here, so that a missing card fails before any rank starts
    device = resolve_device(args.device).type
    spawn(_print_checksum, args.nprocs, (device, args.backend),
          timeout=args.timeout)
    print("multihost run OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
