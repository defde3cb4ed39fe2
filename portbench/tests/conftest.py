"""Helpers of the benchmark's own tests: a cell cut to a size the CPU can
run in seconds (320x240, a few dozen frames), through the same harness."""

import os

import pytest

from portbench import registry

SMALL_FRAMES = 30


def small_config(name):
    c = registry._json(os.path.join(registry.HERE, "configs", f"{name}.json"))
    cam = c["camera"]
    c["camera"] = dict(cam, width=320, height=240, fx=cam["fx"] / 2,
                       fy=cam["fy"] / 2, cx=cam["cx"] / 2, cy=cam["cy"] / 2)
    c["cap"] = dict(c["cap"], max_keyframes=64, max_points=8192)
    if c["vocabulary"]["tree"] == "wide":
        c["vocabulary"] = {"tree": "default", "branching": 10, "depth": 4}
    return c


def small_traffic(name):
    t = registry._json(os.path.join(registry.HERE, "workloads",
                                    f"{name}.json"))
    t.update(frames=SMALL_FRAMES, warm_frames=8, warm_steps=4,
             stage_reps=1, check_keyframes=4, warm_after=4)
    if t["mode"] == "dp":
        t["sequences"] = 2
    return t


@pytest.fixture
def small_cells(monkeypatch):
    """Every cell at the small size, its limits as committed."""
    monkeypatch.setattr(registry, "config", small_config)
    monkeypatch.setattr(registry, "traffic", small_traffic)
    return registry.benchmark()


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
