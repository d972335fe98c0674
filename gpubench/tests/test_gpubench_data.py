"""The benchmark is driven by data: a configuration, a cell and a
per-layer metric come in as new files and entries only; and its frozen
generator gives the program's testing generator's bytes."""

import json

import numpy as np

from gpubench import genome
from gpubench.tests import cells
from twopaco_tpu_torch.testing import bench_data


def test_frozen_generator_matches_bench_data():
    for args in ((3, 5000, 0.01, 1e-4, 2016), (1, 777, 0.05, 0.01, 9), (5, 1234, 0.0, 0.1, 3)):
        a = genome.make_bench_genomes(*args)
        b = bench_data.make_bench_genomes(*args)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_seed_folding_and_fasta(tmp_path):
    assert genome.rng_seed(12) == 12
    assert genome.rng_seed(-1) == (1 << 64) - 1
    assert genome.rng_seed(3_000_000_000) == 3_000_000_000
    seqs = genome.config_genomes(cells.TINY, 2**31 + 5)
    path = tmp_path / "x.fa"
    assert genome.write_fasta(str(path), seqs) == 4 * 6000
    lines = path.read_bytes().split(b"\n")
    assert lines[0] == b">g0" and lines[1] == seqs[0].tobytes() and lines[-1] == b""


def test_new_config_cell_and_metric_from_files(tmp_path):
    config = dict(cells.TINY, name="tiny2", genomes=3, length=5000, k=31)
    root, cell = cells.make_root(tmp_path, config, traffic="sort-r2")
    (root / "gpubench" / "traffic" / "sort-r2.json").write_text(json.dumps(
        {"argv": ["--tpu-engine", "sort", "-r", "2", "-f", "30"]}))
    (root / "gpubench" / "metrics" / "rounds_logged.py").write_text(
        "def read(record):\n"
        "    return sum(b['stdout'].count('Round ') for b in record['builds'])"
        " / len(record['builds'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rounds_logged", "unit": "lines", "better": "lower",
                               "source": "program_counter", "layer": "sort engine rounds",
                               "moves": "setup_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, result, _err = cells.run_cpu(root, cell, trace=True)
    assert rc == 0 and result["correct"] is True
    assert result["metrics"]["rounds_logged"]["value"] >= 4  # two rounds, two lines each
    assert result["metrics"]["rounds_logged"]["unit"] == "lines"
    assert "read_s" in result["metrics"] and "window_mbases_per_s" in result["metrics"]
    assert list(result)[-1] == "compared"
    rc, result, _err = cells.run_cpu(root, cell, trace=False)
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"setup_s"}  # no card: no peak
