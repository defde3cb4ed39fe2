"""The harness finds every cell, configuration, traffic mix, limit file and
per-layer reader by name, and a new cell is new files only."""

import json
import os
import shutil

from portbench import registry


def test_every_named_part_has_its_file():
    bench = registry.benchmark()
    configs = registry.listed("configs")
    traffics = registry.listed("workloads")
    limits = registry.listed("limits")
    readers = registry.listed("metrics")
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["name"] in configs
    for w in bench["workloads"]:
        assert w["config"] in configs and w["traffic"] in traffics
        assert w["name"] in limits
        assert set(registry.limits(w["name"])["limits"])
    for m in bench["per_layer"]:
        assert m["name"] in readers
        assert callable(registry.reader(m["name"]))
        for cell in m["workloads"]:
            registry.cell(cell, bench)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.end_to_end(w, bench)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer(w, bench)


def test_a_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A cell added as a traffic file, a limits file and an entry in
    BENCHMARK.json is listed and loaded, no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = registry.benchmark()
    before = {p: open(os.path.join(registry.HERE, p), "rb").read()
              for kind in ("configs", "workloads", "limits", "metrics")
              for p in [os.path.join(kind, f) for f in
                        os.listdir(os.path.join(registry.HERE, kind))]}
    traffic = dict(registry.traffic("desk"), frames=400)
    (root / "portbench" / "workloads" / "desk_short.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "limits" / "tum_rgbd.desk_short.json").write_text(
        json.dumps(registry.limits("tum_rgbd.desk")))
    bench["workloads"].append({"name": "tum_rgbd.desk_short",
                               "config": "tum_rgbd", "traffic": "desk_short",
                               "chips": 1, "why": "a shorter pass"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", str(root / "portbench"))
    monkeypatch.setattr(registry, "ROOT", str(root))
    assert "desk_short" in registry.listed("workloads")
    cell = registry.cell("tum_rgbd.desk_short")
    assert registry.traffic(cell["traffic"])["frames"] == 400
    assert registry.config(cell["config"])["sensor"] == "rgbd"
    assert registry.limits(cell["name"]) == registry.limits("tum_rgbd.desk")
    monkeypatch.undo()
    after = {p: open(os.path.join(registry.HERE, p), "rb").read()
             for p in before}
    assert after == before
