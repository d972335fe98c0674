"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference loads nothing of the program either (top-level module names
compared whole: twopaco_tpu_torch is not twopaco_tpu)."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench import harness

ROOT = harness.ROOT
GPUBENCH = ROOT / "gpubench"

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import gpubench
from gpubench import harness
for m in pkgutil.iter_modules(gpubench.__path__, "gpubench."):
    if m.name != "gpubench.run":
        importlib.import_module(m.name)
for name in {metrics!r}:
    harness.load_reader(name)
{extra}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "twopaco_tpu", "twopaco_tpu_torch"}}))
"""


def _probe(extra=""):
    metrics = [p.stem for p in (GPUBENCH / "metrics").glob("*.py")]
    code = _PROBE.format(root=str(ROOT), metrics=metrics, extra=extra)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(ROOT))
    assert got.returncode == 0, got.stderr
    return got.stdout.strip().splitlines()[-1]


def test_modules_import_no_jax_nor_the_program():
    # importing the benchmark's modules loads nothing of the program: the
    # harness takes it inside run()
    assert _probe() == "[]"


def test_a_run_s_imports_are_not_jax():
    extra = ("from twopaco_tpu_torch.cli import serve, twopaco\n"
             "from twopaco_tpu_torch.kernels import build")
    assert _probe(extra) == "['twopaco_tpu_torch']"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "twopaco_tpu")


@pytest.mark.parametrize("name", ["reference.py", "control.py", "genome.py", "peaks.py"])
def test_yardstick_sources_import_no_program(name):
    tree = ast.parse((GPUBENCH / name).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "twopaco_tpu"}
    if name in ("reference.py", "genome.py", "peaks.py"):
        assert "twopaco_tpu_torch" not in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "twopaco_tpu_torch_fake", object())
    assert "twopaco_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "twopaco_tpu.fake", object())
    assert "twopaco_tpu.fake" in harness.forbidden_modules()


def test_run_refuses_when_jax_is_loaded(tmp_path, monkeypatch):
    import io

    from gpubench.tests import cells

    root, cell = cells.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", object())
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 3, 0.1, False, device="cpu", root=root,
                     extra_argv=("--device", "cpu"), out=out, err=err)
    assert rc != 0 and out.getvalue() == "" and "jax" in err.getvalue()


def test_run_fails_without_the_program(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copytree(GPUBENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "ecoli62.sort-r1", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert '"correct"' not in got.stdout and "twopaco_tpu_torch" in got.stderr
