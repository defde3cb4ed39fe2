"""State carried between the JAX package and this port as numpy arrays.

`map_state_from_numpy` accepts the field dict that
orb_slam2_tpu/map/checkpoint.py writes (the same npz format, extra keys such
as `__version__` ignored), so a JAX map checkpoint loads into the port:

    data = np.load("map.npz")
    state = map_state_from_numpy(data, device="cuda")

`to_numpy` goes the other way for any of the port's NamedTuples.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from orb_slam2_tpu_torch.map.state import MapState
from orb_slam2_tpu_torch.pipeline.tracking import TrackState


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


def to_numpy(state) -> dict:
    """{field: numpy array} of a MapState / TrackState / Frame."""
    return {f: np.asarray(v.detach().cpu().numpy()) if torch.is_tensor(v)
            else np.asarray(v) for f, v in zip(state._fields, state)}
