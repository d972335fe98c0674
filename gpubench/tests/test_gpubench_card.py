"""The benchmark on the card (marker cuda; skips without one):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda gpubench/tests/test_gpubench_card.py
"""

import copy
import io
import json

import pytest
import torch

from gpubench import control, genome, harness, reference
from gpubench.tests import cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(card, tmp_path):
    fa = tmp_path / "in.fa"
    genome.write_fasta(str(fa), genome.make_bench_genomes(6, 50_000, 0.01, 1e-3, seed=3))
    a, na = reference.reference_dbg(str(fa), 25, device="cpu")
    b, nb = reference.reference_dbg(str(fa), 25, device=card)
    assert na == nb > 0 and bytes(a) == bytes(b)


@pytest.mark.cuda
def test_control_fails_on_the_card(card, tmp_path):
    fa = tmp_path / "in.fa"
    genome.write_fasta(str(fa), genome.make_bench_genomes(1, 400_000, seed=5))
    want, _ = reference.reference_dbg(str(fa), 31, device=card)
    ctrl, _ = control.control_dbg(str(fa), 31, device=card)
    assert reference.records_differing(ctrl, want) > 3


@pytest.mark.cuda
@pytest.mark.parametrize("traffic,trace,repeats", [
    ("sort-r1", True, False), ("sort-r4", False, False), ("sort-r4", True, True)])
def test_small_cell_on_the_card(card, tmp_path, traffic, trace, repeats):
    config = dict(cells.TINY, genomes=8, length=200_000)
    if repeats:
        config = dict(cells.TINY_REPEATS, genomes=8, length=200_000)
    root, cell = cells.make_root(tmp_path, copy.deepcopy(config), traffic=traffic)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 2**31 + 11, 2.0, trace, root=root, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
        assert 0 < result["metrics"]["sort_roofline"]["value"] < 100
        if traffic == "sort-r4":
            assert 0 < result["metrics"]["merge_roofline"]["value"] < 100
        assert "no torch op" not in {name for name, _s in result["breakdown"]["idle_gaps"]}
        assert len(result["breakdown"]["device_ops"]) <= 10
    else:
        assert result["metrics"]["peak_device_gib"]["value"] > 0
