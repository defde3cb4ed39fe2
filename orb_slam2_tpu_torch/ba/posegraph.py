"""Sim3 essential-graph optimization, the loop-closure pose graph (port of
orb_slam2_tpu/ba/posegraph.py; reference Optimizer::OptimizeEssentialGraph,
Optimizer.cc:781-1044).

Nodes are per-keyframe Sim3 poses; edges are spanning-tree, loop and
strong-covisibility relative-Sim3 measurements; the residual is
log(S_meas * S_i * S_j^-1) with identity information, and each LM step's
normal equations are solved matrix-free by block-Jacobi preconditioned CG.
Edge Jacobians come from forward-mode autodiff of the retraction, batched
over all edges (JAX's vmap of jacfwd).  Per-node sums over edges go through
`SegmentSum`, so they are the same every run on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orb_slam2_tpu_torch.ba.schur import SegmentSum, psum
from orb_slam2_tpu_torch.core import lie


class PoseGraphProblem(NamedTuple):
    nodes: torch.Tensor      # [K, 8] Sim3 world->cam
    node_valid: torch.Tensor  # [K]
    node_fixed: torch.Tensor  # [K] (the loop keyframe, Optimizer.cc:834)
    edge_i: torch.Tensor     # [E] i32
    edge_j: torch.Tensor     # [E] i32
    edge_meas: torch.Tensor  # [E, 8] measurement S_j * S_i^-1
    edge_w: torch.Tensor     # [E] weight (0 = inactive)
    fix_scale: bool          # SE3 gauge (stereo / RGB-D)


def edge_residual(S_i, S_j, S_meas):
    """r = log(S_meas * S_i * S_j^-1) [7]; zero when S_meas = S_j S_i^-1."""
    rel = lie.sim3_compose(S_i, lie.sim3_inverse(S_j))
    return lie.sim3_log(lie.sim3_compose(S_meas, rel))


def _f(xi_i, xi_j, S_i, S_j, S_m):
    return edge_residual(lie.sim3_retract(S_i, xi_i),
                         lie.sim3_retract(S_j, xi_j), S_m)


def optimize_pose_graph(prob: PoseGraphProblem, n_outer: int = 20,
                        n_cg: int = 40, lam0: float = 1e-6, group=None):
    """LM with PCG; returns (optimized nodes [K, 8], cost after each
    step [n_outer]).

    With a process `group`, each rank holds a share of the edges
    (distributed/posegraph.py): every per-node sum over edges and the LM
    costs are summed over the group, so all ranks step the same nodes."""
    dev = prob.nodes.device
    Kn = prob.nodes.shape[0]
    var = prob.node_valid & ~prob.node_fixed
    vcol = var[:, None]
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    w = prob.edge_w
    active = w > 0          # inactive edges add exact zeros to every sum
    seg_i = SegmentSum(ei, active, Kn)
    seg_j = SegmentSum(ej, active, Kn)
    mask7 = torch.ones(7, device=dev)
    if prob.fix_scale:
        mask7[6] = 0.0       # project out the scale tangent coordinate
    z = torch.zeros((ei.shape[0], 7), device=dev)
    eye7 = torch.eye(7, device=dev)

    def seg2(vi, vj):
        return psum(seg_i(vi) + seg_j(vj), group)

    def residuals_and_jac(nodes):
        Si, Sj = nodes[ei], nodes[ej]
        r = vmap(_f)(z, z, Si, Sj, prob.edge_meas)                  # [E, 7]
        Ji = vmap(jacfwd(_f, argnums=0))(z, z, Si, Sj, prob.edge_meas)
        Jj = vmap(jacfwd(_f, argnums=1))(z, z, Si, Sj, prob.edge_meas)
        return r, Ji * mask7, Jj * mask7

    nodes = prob.nodes
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(n_outer):
        r, Ji, Jj = residuals_and_jac(nodes)
        g = seg2(torch.einsum('eri,er,e->ei', Ji, r, w),
                 torch.einsum('eri,er,e->ei', Jj, r, w))
        g = torch.where(vcol, g, 0.0)
        Hii = seg2(torch.einsum('eri,erj,e->eij', Ji, Ji, w),
                   torch.einsum('eri,erj,e->eij', Jj, Jj, w))
        Pinv = torch.linalg.inv_ex(Hii + (lam + 1e-8) * eye7)[0]
        Pinv = torch.where(var[:, None, None], Pinv, 0.0)

        def matvec(x):
            x = torch.where(vcol, x, 0.0)
            vi = torch.einsum('erj,ej->er', Ji, x[ei])
            vj = torch.einsum('erj,ej->er', Jj, x[ej])
            v = (vi + vj) * w[:, None]
            out = seg2(torch.einsum('eri,er->ei', Ji, v),
                       torch.einsum('eri,er->ei', Jj, v)) + lam * x
            return torch.where(vcol, out, 0.0)

        x = torch.zeros_like(g)
        rr = -g
        zz = torch.einsum('kij,kj->ki', Pinv, rr)
        p = zz
        rz = torch.sum(rr * zz)
        for _ in range(n_cg):
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            zz = torch.einsum('kij,kj->ki', Pinv, rr)
            rz_new = torch.sum(rr * zz)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = zz + beta * p
            rz = rz_new
        dx = x * mask7
        new_nodes = torch.where(vcol, lie.sim3_retract(nodes, dx), nodes)

        cost_old = psum(torch.sum(torch.sum(r * r, -1) * w), group)
        r_new = vmap(_f)(z, z, new_nodes[ei], new_nodes[ej], prob.edge_meas)
        cost_new = psum(torch.sum(torch.sum(r_new * r_new, -1) * w), group)
        ok = (cost_new < cost_old) & torch.all(torch.isfinite(new_nodes))
        nodes = torch.where(ok, new_nodes, nodes)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 8.0), 1e-12, 1e6)
        costs.append(cost_new)
    return nodes, torch.stack(costs)
