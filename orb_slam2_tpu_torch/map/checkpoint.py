"""Map checkpoint / resume (port of orb_slam2_tpu/map/checkpoint.py).

The map is a NamedTuple of fixed-shape tensors (map/state.py), so a
checkpoint is one compressed npz: every field under its name plus
`__version__`.  The format is the JAX package's, version 1, so a map saved
by either package loads in the other.  A saved map reloads into a fresh
session for localization-only tracking on a prebuilt map (the reference's
README.md:232-239 use case).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_tpu_torch.map.state import MapState

_FORMAT_VERSION = 1


def save_map(state: MapState, path: str) -> None:
    """Serialize the full MapState to a compressed npz."""
    arrays = {f: v.detach().cpu().numpy() for f, v in zip(state._fields,
                                                          state)}
    np.savez_compressed(path, __version__=np.asarray(_FORMAT_VERSION),
                        **arrays)


def load_map(path: str, device=None) -> MapState:
    """Reload a MapState saved by save_map (either package's) onto
    `device`.  Raises ValueError for a newer format version or a missing
    field."""
    data = np.load(path)
    ver = int(data["__version__"]) if "__version__" in data else 0
    if ver > _FORMAT_VERSION:
        raise ValueError(f"map checkpoint version {ver} is newer than "
                         f"supported ({_FORMAT_VERSION})")
    missing = [f for f in MapState._fields if f not in data]
    if missing:
        raise ValueError(f"map checkpoint missing fields: {missing}")
    return MapState(*[torch.as_tensor(data[f], device=device)
                      for f in MapState._fields])
