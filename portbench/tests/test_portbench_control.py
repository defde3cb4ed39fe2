"""The control (the plain reference put in the program's place in
bfloat16) fails the committed limits: on the CPU at a small size, and on
the card at each cell's own size (`cuda` marker)."""

import time

import pytest

from portbench import control, registry, run

BIG_SEED = 2 ** 31 + 99


def control_fails(cell_name, bench, seconds, device):
    cell = registry.cell(cell_name, bench)
    keep = {}
    res = run.run_cell(bench, cell, BIG_SEED, seconds, False, device,
                       time.time(), keep=keep)
    assert res["correct"] is True, res["checks"]
    lim = registry.limits(cell_name)["limits"]
    low = control.bf16_numbers(keep, device)
    failed = [k for k, v in low.items()
              if k in lim and v is not None and v > lim[k]]
    return failed, low


def test_control_fails_at_a_small_size(small_cells):
    failed, low = control_fails("tum_rgbd.desk", small_cells, 8.0, "cpu")
    assert "desc_bit_share" in failed and "bow_gap" in failed, low


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tum_rgbd.desk", "kitti_stereo.drive",
                                  "tum_rgbd.fleet8", "tum_rgbd.localize"])
def test_control_fails_at_the_cells_size(card, cell):
    bench = registry.benchmark()
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    failed, low = control_fails(cell, bench, 5.0, "cuda")
    assert failed, low
