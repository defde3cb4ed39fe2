"""State carried between the JAX package and this port as numpy arrays.

`map_state_from_numpy` accepts the field dict that
orb_slam2_tpu/map/checkpoint.py writes (the same npz format, extra keys such
as `__version__` ignored), so a JAX map checkpoint loads into the port:

    data = np.load("map.npz")
    state = map_state_from_numpy(data, device="cuda")

The same holds for stacked states with a leading sequence axis
(`distributed/dp.py`): every field keeps its shape, [S, ...] included.
`ba_problem_from_numpy` and `pose_graph_problem_from_numpy` take a solver
problem's fields (the JAX `BAProblem`'s / `PoseGraphProblem`'s as numpy
arrays), so one problem can be handed to both packages' solvers.
`to_numpy` goes the other way for any of the port's NamedTuples.
`vocabulary_from_numpy` takes a vocabulary's fields (the JAX `Vocabulary`'s
as a dict, or its npz file), so one vocabulary can serve both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from orb_slam2_tpu_torch.ba.posegraph import PoseGraphProblem
from orb_slam2_tpu_torch.ba.schur import BAProblem
from orb_slam2_tpu_torch.map.state import MapState
from orb_slam2_tpu_torch.pipeline.frame import Frame
from orb_slam2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_tpu_torch.place.vocab import Vocabulary


def _from_numpy(cls, fields: Mapping[str, np.ndarray], device):
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {missing}")
    return cls(*[torch.as_tensor(np.array(fields[f]), device=device)
                 for f in cls._fields])


def map_state_from_numpy(fields: Mapping[str, np.ndarray],
                         device=None) -> MapState:
    return _from_numpy(MapState, fields, device)


def track_state_from_numpy(fields: Mapping[str, np.ndarray],
                           device=None) -> TrackState:
    return _from_numpy(TrackState, fields, device)


def frame_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Frame:
    return _from_numpy(Frame, fields, device)


def ba_problem_from_numpy(fields: Mapping[str, np.ndarray],
                          device=None) -> BAProblem:
    """`bf` becomes a Python float, as the port's solvers take it."""
    prob = _from_numpy(BAProblem, fields, device)
    return prob._replace(bf=float(np.asarray(fields["bf"])))


def pose_graph_problem_from_numpy(fields: Mapping[str, np.ndarray],
                                  device=None) -> PoseGraphProblem:
    """`fix_scale` becomes a Python bool, as the port's solver takes it."""
    prob = _from_numpy(PoseGraphProblem, fields, device)
    return prob._replace(fix_scale=bool(np.asarray(fields["fix_scale"])))


def vocabulary_from_numpy(fields: Mapping) -> Vocabulary:
    """The port's Vocabulary from the fields of another one (e.g.
    `dataclasses.asdict` of the JAX package's, or `np.load` of its npz)."""
    return Vocabulary(
        k=int(fields["k"]), depth=int(fields["depth"]),
        node_children=np.asarray(fields["node_children"], np.int32),
        node_desc=np.asarray(fields["node_desc"], np.uint8),
        word_id=np.asarray(fields["word_id"], np.int32),
        word_weight=np.asarray(fields["word_weight"], np.float32),
        n_words=int(fields["n_words"]), levels_up=int(fields["levels_up"]))


def to_numpy(state) -> dict:
    """{field: numpy array} of a MapState / TrackState / Frame or a
    solver problem."""
    return {f: np.asarray(v.detach().cpu().numpy()) if torch.is_tensor(v)
            else np.asarray(v) for f, v in zip(state._fields, state)}
