"""Distributed Sim3 essential-graph optimisation over a process group
(port of orb_slam2_tpu/distributed/posegraph.py).

The edges are sharded over the group (rank r holds the r-th contiguous
block, as `P("edge")`); node states stay replicated, and every cross-edge
sum of the CG-LM solver is all-reduced (`optimize_pose_graph(group=...)`),
so each rank ends every LM step with the same nodes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from orb_slam2_tpu_torch.ba.posegraph import (PoseGraphProblem,
                                              optimize_pose_graph)
from orb_slam2_tpu_torch.distributed.ba import _group, _pad


def make_edge_mesh(n_devices: int | None = None):
    return _group(n_devices)


def pad_edges(prob: PoseGraphProblem, n_shards: int) -> PoseGraphProblem:
    """Pad the edge arrays so E divides n_shards (padding edges: weight 0,
    identity measurement)."""
    pad = (-prob.edge_i.shape[0]) % n_shards
    if pad == 0:
        return prob
    ident = torch.zeros((pad, 8), dtype=prob.edge_meas.dtype,
                        device=prob.edge_meas.device)
    ident[:, 0] = 1.0
    ident[:, 7] = 1.0
    return prob._replace(
        edge_i=_pad(prob.edge_i, pad, 0), edge_j=_pad(prob.edge_j, pad, 0),
        edge_meas=torch.cat([prob.edge_meas, ident]),
        edge_w=_pad(prob.edge_w, pad, 0.0))


def distributed_pose_graph(prob: PoseGraphProblem, mesh, n_outer: int = 20,
                           n_cg: int = 40):
    """`optimize_pose_graph` with the edges sharded over the group `mesh`;
    returns (nodes [K, 8], costs [n_outer]), the same on every rank."""
    n, r = dist.get_world_size(mesh), dist.get_rank(mesh)
    prob = pad_edges(prob, n)
    E = prob.edge_i.shape[0]
    sl = slice(r * E // n, (r + 1) * E // n)
    local = prob._replace(edge_i=prob.edge_i[sl], edge_j=prob.edge_j[sl],
                          edge_meas=prob.edge_meas[sl], edge_w=prob.edge_w[sl])
    return optimize_pose_graph(local, n_outer=n_outer, n_cg=n_cg, group=mesh)
