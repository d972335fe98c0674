"""The port stands alone: it imports neither JAX nor twopaco_tpu, and
its kernel loader raises (no fallback) when nvcc is missing."""

import os
import subprocess
import sys

import pytest
import torch

from twopaco_tpu_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import twopaco_tpu_torch
names = [m.name for m in pkgutil.walk_packages(twopaco_tpu_torch.__path__, "twopaco_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "twopaco_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_loader_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    lib = build.KernelLibrary(build_dir=tmp_path / "build", candidates=())
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        lib.get()
    assert not (tmp_path / "build").exists()


def test_device_dispatch():
    cpu = torch.zeros(2)
    assert build.on_cpu(cpu, cpu)
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):  # neither the CPU nor CUDA: no plain path
        build.on_cpu(meta)
    with pytest.raises(ValueError):
        build.on_cpu(cpu, meta)
