"""The CLI's `bench` (orb_slam2_tpu_torch/bench.py, the counterpart of the
root bench.py), on the CPU: a short run at tests/test_e2e.py's 320x240
configuration (`--small`; the default one costs minutes here) prints ONE
JSON line with bench.py's keys.  Without a card and with no device named
the command raises (tests/test_torch_imports.py)."""

import json

import torch

from orb_slam2_tpu_torch import cli

KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m",
        "tracked_frames", "total_frames", "keyframes", "map_points",
        "frame_ms_p90", "frame_ms_max", "stages"}


def test_bench_prints_bench_py_keys(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_FRAMES", "12")
    monkeypatch.setenv("BENCH_STEREO", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cli.main(["bench", "--device", "cpu", "--small"])
    finally:
        torch.set_num_threads(n)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == json.loads(json.dumps(out))
    assert KEYS <= set(got) and "stereo" not in got
    assert got["metric"] == "tracked_frames_per_s_per_chip"
    assert got["unit"] == "frames/s" and got["total_frames"] == 12
    assert got["value"] > 0 and got["tracked_frames"] >= 8
    assert got["keyframes"] >= 2 and got["map_points"] > 0
    assert set(got["stages"]) == {"extract_ms", "track_ms", "keyframe_ms"}
    assert got["device"] == "cpu" and got["captured"] is False
