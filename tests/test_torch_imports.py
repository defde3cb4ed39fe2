"""The PyTorch port stands alone: no file of `orb_slam2_tpu_torch/` and
neither `chip_smoke.py` imports `jax` or the JAX package `orb_slam2_tpu`,
nor any of OpenCV, PIL, PyYAML or matplotlib (absent where the card is),
and importing the port in a fresh interpreter loads none of them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "orb_slam2_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


FORBIDDEN = ("jax", "jaxlib", "orb_slam2_tpu", "cv2", "PIL", "yaml",
             "matplotlib")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    """No import of JAX, the JAX package, OpenCV, PIL, PyYAML or
    matplotlib."""
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["orb_slam2_tpu_torch." + m for m in (
        "convert", "pipeline.system", "frontend.fast_cuda", "io.synthetic",
        "io.evaluate", "io.settings", "io.datasets", "io.png",
        "map.checkpoint", "cli", "native_build", "place.vocab",
        "place.database", "pipeline.reloc", "pipeline.loopclosing",
        "ba.posegraph", "ba.async_gba", "solvers.epnp", "solvers.sim3",
        "solvers.pose_lm_cuda", "cuda_build", "frontend.extractor",
        "viz.raster", "viz.viewer", "viz.ar", "io.ros", "distributed",
        "distributed.runtime", "distributed.ba", "distributed.posegraph",
        "distributed.dp", "distributed.launch", "core.control", "bench",
        "frame_profile")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _builders():
    """Each public builder of the port called with no device."""
    from orb_slam2_tpu_torch import config
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    from orb_slam2_tpu_torch.frontend.extractor import (
        build_extractor, build_extractor_perlevel)
    from orb_slam2_tpu_torch.pipeline.frame import (build_mono_frame_fn,
                                                    build_rgbd_frame_fn,
                                                    build_stereo_frame_fn)
    from orb_slam2_tpu_torch.pipeline.system import DEFAULT_VOCAB, \
        build_full_step
    from orb_slam2_tpu_torch.distributed.dp import (build_dp_step,
                                                    make_batch_states)
    from orb_slam2_tpu_torch.place.vocab import Vocabulary, build_transform
    cfg = config.SLAMConfig()
    rgbd = cfg.replace(sensor=config.RGBD)
    return {
        "build_atlas_extractor": lambda: build_atlas_extractor(cfg.orb, 48,
                                                               64),
        "build_extractor": lambda: build_extractor(cfg.orb, 48, 64),
        "build_extractor_perlevel": lambda: build_extractor_perlevel(
            cfg.orb, 48, 64),
        "build_mono_frame_fn": lambda: build_mono_frame_fn(cfg),
        "build_rgbd_frame_fn": lambda: build_rgbd_frame_fn(cfg),
        "build_stereo_frame_fn": lambda: build_stereo_frame_fn(cfg),
        "build_full_step": lambda: build_full_step(cfg),
        "build_transform": lambda: build_transform(
            Vocabulary.load(DEFAULT_VOCAB)),
        "build_dp_step": lambda: build_dp_step(rgbd),
        "make_batch_states": lambda: make_batch_states(rgbd, 2),
    }


@pytest.mark.parametrize("name", ["build_atlas_extractor", "build_extractor",
                                  "build_extractor_perlevel",
                                  "build_mono_frame_fn", "build_rgbd_frame_fn",
                                  "build_stereo_frame_fn", "build_full_step",
                                  "build_transform", "build_dp_step",
                                  "make_batch_states"])
def test_builders_default_to_cuda(name, monkeypatch):
    """With no device named, a builder puts its constants on the card, so
    with no card it raises instead of running on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _builders()[name]()


def test_ar_session_runs_on_cuda_by_default(monkeypatch):
    """ARSession drives a session made with no device: with no card, making
    it raises instead of running on the CPU."""
    from orb_slam2_tpu_torch import config
    from orb_slam2_tpu_torch.pipeline.system import SLAM
    from orb_slam2_tpu_torch.viz.ar import ARSession
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ARSession(SLAM(config.SLAMConfig()))


def test_bench_runs_on_cuda_by_default(monkeypatch):
    """The CLI's `bench` with no device: with no card it raises (the
    command exits non-zero) instead of running on the CPU."""
    from orb_slam2_tpu_torch import cli
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])


def test_capture_needs_a_card():
    """A session asked to capture its step on the CPU refuses."""
    from orb_slam2_tpu_torch import config
    from orb_slam2_tpu_torch.pipeline.system import SLAM
    with pytest.raises(ValueError, match="CUDA graph"):
        SLAM(config.SLAMConfig(), device="cpu", capture=True)
