"""Distributed bundle adjustment over a process group (port of
orb_slam2_tpu/distributed/ba.py).

A JAX mesh axis becomes a `torch.distributed` process group: rank r of n
holds the r-th contiguous block of the sharded rows, as `P("obs")` gives
device r of an n-device mesh, so both packages sum the same rows on the
same shard.  The Schur solver all-reduces every cross-row sum
(`ba_solve(group=...)`), so every rank ends each LM step with the same
replicated cameras.

v1 (`distributed_ba_solve`) shards the observation rows and replicates
cameras and landmarks; v2 (`distributed_ba_solve_sharded`) shards the
landmarks with their rows (point-major problems), keeping the point-side
Schur work local to its rank.  Sharded outputs (chi2, inlier, v2's
points) come back whole on every rank: each rank writes its block into a
zero array of full size and one SUM all-reduce assembles them — one
writer per row, so the sum is exact.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from orb_slam2_tpu_torch.ba.schur import BAProblem, BAResult, ba_solve, psum


def _group(n_devices: int | None):
    """The first `n_devices` ranks (all of them by default) as a group."""
    world = dist.get_world_size()
    n = n_devices or world
    if n == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def make_obs_mesh(n_devices: int | None = None):
    return _group(n_devices)


def make_pt_mesh(n_devices: int | None = None):
    return _group(n_devices)


def _pad(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if n == 0:
        return x
    return torch.cat([x, torch.full((n,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def pad_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the observation arrays so R divides n_shards (padding rows have
    zero weight and point at camera 0 / point 0 harmlessly)."""
    pad = (-prob.obs_cam.shape[0]) % n_shards
    if pad == 0:
        return prob
    return prob._replace(
        obs_cam=_pad(prob.obs_cam, pad, 0), obs_pid=_pad(prob.obs_pid, pad, 0),
        obs_uv=_pad(prob.obs_uv, pad, 0.0),
        obs_ur=_pad(prob.obs_ur, pad, -1.0),
        obs_w=_pad(prob.obs_w, pad, 0.0))


def _rows(prob: BAProblem, sl: slice) -> BAProblem:
    return prob._replace(obs_cam=prob.obs_cam[sl], obs_pid=prob.obs_pid[sl],
                         obs_uv=prob.obs_uv[sl], obs_ur=prob.obs_ur[sl],
                         obs_w=prob.obs_w[sl])


def _assemble(group, R: int, rows: slice, chi2, inlier, M: int = 0,
              pts: slice | None = None, points=None):
    """Whole chi2 [R], inlier [R] and points [M, 3] on every rank from each
    rank's block: one SUM all-reduce over a zero-filled buffer."""
    buf = torch.zeros(2 * R + 3 * M, dtype=torch.float32, device=chi2.device)
    buf[:R][rows] = chi2
    buf[R:2 * R][rows] = inlier.to(torch.float32)
    if points is not None:
        buf[2 * R:].view(M, 3)[pts] = points
    buf = psum(buf, group)
    return buf[:R], buf[R:2 * R] > 0.5, buf[2 * R:].view(M, 3)


def distributed_ba_solve(prob: BAProblem, mesh, n_outer: int = 10,
                         n_cg: int = 30, **kw) -> BAResult:
    """`ba_solve` with the observation rows sharded over the group `mesh`
    (cameras and landmarks replicated)."""
    n, r = dist.get_world_size(mesh), dist.get_rank(mesh)
    prob = pad_problem(prob, n)
    R = prob.obs_cam.shape[0]
    rows = slice(r * R // n, (r + 1) * R // n)
    res = ba_solve(_rows(prob, rows), n_outer=n_outer, n_cg=n_cg, group=mesh,
                   **kw)
    chi2, inlier, _ = _assemble(mesh, R, rows, res.chi2, res.inlier)
    return res._replace(chi2=chi2, inlier=inlier)


def pad_point_major(prob: BAProblem, D: int, n_shards: int) -> BAProblem:
    """Pad a point-major problem (R = M*D rows, rows [p*D..p*D+D) belong to
    point p) so M divides n_shards; padding points are fixed and their rows
    weigh 0."""
    M = prob.points.shape[0]
    assert prob.obs_w.shape[0] == M * D, (prob.obs_w.shape, M, D)
    pad = (-M) % n_shards
    if pad == 0:
        return prob
    pr = pad * D
    return prob._replace(
        points=_pad(prob.points, pad, 0.0),
        pt_var=_pad(prob.pt_var, pad, False),
        obs_cam=_pad(prob.obs_cam, pr, 0), obs_pid=_pad(prob.obs_pid, pr, 0),
        obs_uv=_pad(prob.obs_uv, pr, 0.0), obs_ur=_pad(prob.obs_ur, pr, -1.0),
        obs_w=_pad(prob.obs_w, pr, 0.0))


def distributed_ba_solve_sharded(prob: BAProblem, mesh, D: int,
                                 n_outer: int = 10, n_cg: int = 30,
                                 **kw) -> BAResult:
    """Map-block partitioned BA: landmarks AND their observation rows are
    sharded over the group `mesh` (every row of a point lives with the
    point), cameras replicated.  Point-side work — Hpp/bp, the damped 3x3
    inverses, back-substitution, the landmark stage of each CG product —
    stays on the point's rank; only the reduced camera system's sums and
    the LM costs cross ranks.

    `prob` must be point-major (`ba/local.build_global_problem_point_major`):
    R = M*D with rows [p*D, (p+1)*D) owned by point p."""
    n, r = dist.get_world_size(mesh), dist.get_rank(mesh)
    prob = pad_point_major(prob, D, n)
    M = prob.points.shape[0]
    M_loc = M // n
    pts = slice(r * M_loc, (r + 1) * M_loc)
    rows = slice(r * M_loc * D, (r + 1) * M_loc * D)
    # point-major rows: the shard-local point ids are repeat(arange(M_loc), D)
    local_pid = torch.arange(M_loc, dtype=prob.obs_pid.dtype,
                             device=prob.obs_pid.device).repeat_interleave(D)
    local = _rows(prob, rows)._replace(points=prob.points[pts],
                                       pt_var=prob.pt_var[pts],
                                       obs_pid=local_pid)
    res = ba_solve(local, n_outer=n_outer, n_cg=n_cg, group=mesh,
                   pt_owner_complete=True, **kw)
    chi2, inlier, points = _assemble(mesh, M * D, rows, res.chi2, res.inlier,
                                     M, pts, res.points)
    return res._replace(points=points, chi2=chi2, inlier=inlier)
