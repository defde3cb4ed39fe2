"""Multi-process runtime: `torch.distributed` wiring (port of
orb_slam2_tpu/distributed/runtime.py).

Each process calls `init_multihost()` once at startup; the sharded solvers
of `distributed/ba.py` and `distributed/posegraph.py` then take the group
that `global_pt_mesh()` returns (every process), or any other process
group, in the place of a JAX mesh.

    python -m orb_slam2_tpu_torch.distributed.launch --nprocs 2 \\
        --backend gloo --device cpu

Environment contract (set by the launcher, or by a scheduler):

    SLAM_COORDINATOR  host:port of process 0   (default 127.0.0.1:9911)
    SLAM_NUM_PROCS    total process count
    SLAM_PROC_ID      this process's rank

The backend is "nccl" when every rank of this host has a card of its own
and "gloo" otherwise (CPU tensors, or more ranks than cards: NCCL refuses
two ranks on one device, while gloo all-reduces CUDA tensors through host
buffers).  A named backend is used as named and never swapped for another.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# rendezvous and collective timeout: a rank that never joins fails the run
# instead of hanging it
JOIN_TIMEOUT_S = 120


def default_backend(num_processes: int) -> str:
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Join the process group from the arguments or the SLAM_* env vars.
    No-op when SLAM_NUM_PROCS is absent or 1 and no count is given
    (single-process operation stays zero-config)."""
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("SLAM_NUM_PROCS", "1"))
    if num_processes <= 1:
        return
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR",
                                                "127.0.0.1:9911")
    process_id = process_id if process_id is not None else \
        int(os.environ.get("SLAM_PROC_ID", "0"))
    backend = backend or default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_pt_mesh():
    """The group of every process — pass it to
    `distributed_ba_solve_sharded` for map-block BA over all of them."""
    return dist.group.WORLD
