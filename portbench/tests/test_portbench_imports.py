"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import registry, run

JAX_NAMES = {"jax", "jaxlib", "flax", "orb_slam2_tpu"}


def sources():
    for d, _, files in os.walk(registry.HERE):
        if "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, registry.HERE))
def test_no_jax_import(path):
    assert not set(top_imports(path)) & JAX_NAMES


@pytest.mark.parametrize("name", ["reference.py", "check.py", "scene.py",
                                  "render.py", "vocab.py"])
def test_reference_side_imports_nothing_of_the_program(name):
    names = set(top_imports(os.path.join(registry.HERE, name)))
    assert "orb_slam2_tpu_torch" not in names and not names & JAX_NAMES


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "orb_slam2_tpu_torch_fake", object())
    assert run.forbidden_modules() == [] or \
        set(run.forbidden_modules()) <= JAX_NAMES
    assert "orb_slam2_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "orb_slam2_tpu.fake", object())
    assert "orb_slam2_tpu" in run.forbidden_modules()


def test_harness_and_program_load_no_jax():
    """In a fresh process: every benchmark module and the program's
    modules the harness uses leave no JAX module loaded."""
    code = ("import portbench.run, portbench.harness, portbench.check, "
            "portbench.control, portbench.trace\n"
            "from orb_slam2_tpu_torch.pipeline import system, loopclosing\n"
            "from orb_slam2_tpu_torch.distributed import dp\n"
            "from portbench import run\n"
            "print(run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=registry.ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
