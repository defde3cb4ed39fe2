"""Sharded solvers over `torch.distributed` process groups, the
multi-process runtime, and data-parallel multi-sequence SLAM (port of
orb_slam2_tpu/distributed/).

Exports are lazy, as in the JAX package, so that importing the runtime
does not import the SLAM pipeline.
"""

_EXPORTS = {
    "distributed_ba_solve": "orb_slam2_tpu_torch.distributed.ba",
    "distributed_ba_solve_sharded": "orb_slam2_tpu_torch.distributed.ba",
    "make_obs_mesh": "orb_slam2_tpu_torch.distributed.ba",
    "make_pt_mesh": "orb_slam2_tpu_torch.distributed.ba",
    "distributed_pose_graph": "orb_slam2_tpu_torch.distributed.posegraph",
    "make_edge_mesh": "orb_slam2_tpu_torch.distributed.posegraph",
    "init_multihost": "orb_slam2_tpu_torch.distributed.runtime",
    "global_pt_mesh": "orb_slam2_tpu_torch.distributed.runtime",
    "build_dp_step": "orb_slam2_tpu_torch.distributed.dp",
    "build_sharded_step": "orb_slam2_tpu_torch.distributed.dp",
    "make_batch_states": "orb_slam2_tpu_torch.distributed.dp",
    "shard_batch": "orb_slam2_tpu_torch.distributed.dp",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)
