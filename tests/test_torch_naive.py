"""The port's naive constructor (cli/naive.py), self test
(testing/selftest.py), the CLI's --test and `python -m twopaco_tpu_torch`,
against the JAX package's naive constructor and the port's own pipeline on
the CPU. Junction lists: every comparison is byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from twopaco_tpu.cli import naive as jnaive
from twopaco_tpu_torch import dna
from twopaco_tpu_torch.cli import naive, twopaco
from twopaco_tpu_torch.io import fasta
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, build_junctions
from twopaco_tpu_torch.testing import oracle, selftest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_FA = os.path.join(ROOT, "tests", "golden", "example.fa")
# the self test's small sweep (tests/test_edge_cases.py's CLI smoke test)
SMALL = dict(tests=1, length=400, chr_number=2, k_values=(5,), rounds_values=(1, 2), seed=11)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _genomes(seed, n=3, length=600):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [base] + [oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(n - 1)]


@pytest.mark.parametrize("k", [5, 9, 11, 33])
def test_naive_equals_jax(tmp_path, k):
    """The same sequences (N runs, ambiguity letters, a sequence shorter
    than k): the port's naive .dbg is the JAX package's, byte for byte."""
    seqs = _genomes(k)
    seqs[1] = seqs[1][:100] + "YRKM" + seqs[1][104:]
    seqs.insert(1, "ACG")
    out_t, out_j = str(tmp_path / "t.dbg"), str(tmp_path / "j.dbg")
    n = naive.naive_junction_file(seqs, k, out_t)
    assert n == jnaive.naive_junction_file(seqs, k, out_j) and n > 0
    assert _read(out_t) == _read(out_j) and os.path.getsize(out_t) > 0


@pytest.mark.parametrize("k", [5, 9])
def test_naive_equals_pipeline(tmp_path, k):
    """The naive .dbg is the port's pipeline's (--device cpu) byte for
    byte: the same ids, stubs and separators."""
    seqs = _genomes(99 + k, n=2)
    out_n, out_p = str(tmp_path / "n.dbg"), str(tmp_path / "p.dbg")
    naive.naive_junction_file(seqs, k, out_n)
    cfg = PipelineConfig(k=k, positions_per_row=128, rows_per_batch=4)
    build_junctions(None, cfg, out_p, sequences=[(i, dna.encode(s)) for i, s in
                                                 enumerate(seqs)], device="cpu")
    assert _read(out_n) == _read(out_p)


def test_naive_cli(tmp_path, capsys):
    """The CLI on the reference example (tests/golden/example.fa) at k =
    11: the JAX CLI's bytes and count; an even k exits 1."""
    out_t, out_j = str(tmp_path / "t.dbg"), str(tmp_path / "j.dbg")
    assert naive.main(["-k", "11", EXAMPLE_FA, "-o", out_t]) == 0
    assert "Distinct junctions = 7" in capsys.readouterr().out
    assert jnaive.main(["-k", "11", EXAMPLE_FA, "-o", out_j]) == 0
    assert _read(out_t) == _read(out_j)
    assert naive.main(["-k", "10", EXAMPLE_FA, "-o", out_t]) == 1


def test_selftest_small_sweep(tmp_path):
    """run_tests at the small sweep on the CPU: the sort and Bloom engines'
    marks equal the oracle's, every junction resolves."""
    lines = []
    assert selftest.run_tests(**SMALL, tmpdir=str(tmp_path), log=lines.append, device="cpu")
    assert lines == ["Test # 0 PASSED"]


def test_selftest_reports_a_wrong_mark(tmp_path, monkeypatch):
    """A junction list that disagrees with the oracle fails the test."""
    real = oracle.find_junctions_naively

    def one_more(seqs, k):
        junc, marks = real(seqs, k)
        marks[0][len(seqs[0]) // 2] ^= True
        return junc, marks

    monkeypatch.setattr(oracle, "find_junctions_naively", one_more)
    lines = []
    assert not selftest.run_tests(**SMALL, tmpdir=str(tmp_path), log=lines.append,
                                  device="cpu")
    assert lines[0].startswith("ERROR at chr 0") and lines[-1] == "Test # 0 FAILED"


def test_cli_test_flag(monkeypatch, capsys):
    """twopaco --test --device cpu runs the self test on the CPU (here at
    the small sweep) and exits 0 when it passes, 1 when it fails; on cuda
    without a card it raises."""
    calls, real = [], selftest.run_tests

    def small(**kw):
        calls.append(kw["device"])
        return real(**SMALL, **kw)

    monkeypatch.setattr(selftest, "run_tests", small)
    assert twopaco.main(["--test", "--device", "cpu"]) == 0
    assert "Test # 0 PASSED" in capsys.readouterr().out
    assert calls == [torch.device("cpu")]
    monkeypatch.setattr(selftest, "run_tests", lambda **kw: False)
    assert twopaco.main(["--test", "--device", "cpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            twopaco.main(["--test"])


def test_python_m_package_is_the_cli(tmp_path):
    """python -m twopaco_tpu_torch runs the twopaco CLI."""
    out = str(tmp_path / "o.dbg")
    proc = subprocess.run(
        [sys.executable, "-m", "twopaco_tpu_torch", "-k", "11", "-f", "20", "--device", "cpu",
         EXAMPLE_FA, "-o", out], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Distinct junctions = 7" in proc.stdout
    seqs = list(fasta.read_sequences_text([EXAMPLE_FA]))
    naive.naive_junction_file(seqs, 11, str(tmp_path / "n.dbg"))
    assert _read(out) == _read(str(tmp_path / "n.dbg"))
