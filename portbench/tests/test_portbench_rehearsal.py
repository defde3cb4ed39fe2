"""A tiny run of the harness on the CPU (its look for a card skipped):
the last line's shape, and `correct` false under each fault the cells can
have: a step that returns its state unchanged, half of the dp batch left
out, and an answer altered where it is produced.  The exchange between
chips has no cell here (every cell takes one card)."""

import io
import json
import time

import pytest

from portbench import registry, run

BIG_SEED = 2 ** 31 + 4242


def rehearse(cell_name, bench, seconds=8.0, traced=False):
    cell = registry.cell(cell_name, bench)
    return run.run_cell(bench, cell, BIG_SEED, seconds, traced, "cpu",
                        time.time())


def test_last_line_shape(small_cells):
    res = rehearse("tum_rgbd.desk", small_cells)
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    last = err.getvalue().strip().splitlines()
    assert last[-1].startswith("check fill:")
    assert any(x.startswith("check ate_m: value") for x in last)


def test_traced_line_reports_per_layer_metrics(small_cells):
    """On the CPU only the host-clock per-layer metric is there."""
    res = rehearse("tum_rgbd.desk", small_cells, traced=True)
    assert set(res["metrics"]) == {"frame_ms_p50"}


def _unchanged_session(monkeypatch):
    from orb_slam2_tpu_torch.pipeline import system
    monkeypatch.setattr(system.SLAM, "_run_program",
                        lambda self, loc_only: None)


def _unchanged_dp(monkeypatch):
    from orb_slam2_tpu_torch.distributed import dp

    def step(self, img, depth, fid, t):
        self.steps += 1
    monkeypatch.setattr(dp.DPProgram, "step", step)


def _half_batch(monkeypatch):
    from orb_slam2_tpu_torch.distributed import dp
    real = dp.DPProgram.step

    def step(self, img, depth, fid, t):
        h = img.shape[0] // 2
        img, depth = img.clone(), depth.clone()
        img[h:], depth[h:] = img[:1], depth[:1]
        return real(self, img, depth, fid, t)
    monkeypatch.setattr(dp.DPProgram, "step", step)


def _altered_descriptors(monkeypatch):
    from orb_slam2_tpu_torch.pipeline import system
    real = system.build_frame_fn

    def build(cfg, device=None):
        fn = real(cfg, device)

        def frame(*a):
            f = fn(*a)
            return f._replace(desc=f.desc ^ 0x55)
        return frame
    monkeypatch.setattr(system, "build_frame_fn", build)


@pytest.mark.parametrize("cell,fault", [
    ("tum_rgbd.desk", _unchanged_session),
    ("tum_rgbd.desk", _altered_descriptors),
    ("tum_rgbd.fleet8", _unchanged_dp),
    ("tum_rgbd.fleet8", _half_batch),
], ids=["session-unchanged", "session-altered-descriptors",
        "dp-unchanged", "dp-half-batch"])
def test_fault_makes_correct_false(small_cells, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = rehearse(cell, small_cells)
    assert res["correct"] is False, res["checks"]
