"""The port's slice end to end against twopaco_tpu: the .dbg written by
twopaco_tpu_torch (CPU: the plain versions) must be byte-identical to
the JAX package's sort engine on the same input and flags."""

import os

import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.cli.twopaco import main as jax_main
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.cli.twopaco import main as port_main
from twopaco_tpu_torch.io import junctions
from twopaco_tpu_torch.passes.pipeline import INVALID_VERTEX, config_from_jax
from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _both(tmp_path, jcfg, paths=None, sequences=None):
    """-> (JAX .dbg bytes, port .dbg bytes, port Enumerator)."""
    jout, tout = str(tmp_path / "jax.dbg"), str(tmp_path / "port.dbg")
    build_junctions(paths, jcfg, out_path=jout, sequences=sequences)
    enum = build_junctions_sorted(
        paths, config_from_jax(jcfg), tout, sequences=sequences, device="cpu"
    )
    return open(jout, "rb").read(), open(tout, "rb").read(), enum


def _genomes(seed, length=2500, n=4):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(n - 1)]


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_sweep_byte_identical(tmp_path, k, seed):
    seqs = _genomes(seed)
    sequences = [(i, jdna.encode(s)) for i, s in enumerate(seqs)]
    jcfg = JaxConfig(k=k, filter_bits=20, positions_per_row=256, rows_per_batch=4)
    jb, tb, enum = _both(tmp_path, jcfg, sequences=sequences)
    assert jb == tb and len(tb) > 0
    # and the naive oracle's marks and junction set
    junc, want = oracle.find_junctions_naively(seqs, k)
    chrs, pos, _ids = junctions.read_junctions(str(tmp_path / "port.dbg"))
    got = [np.zeros(len(s), bool) for s in seqs]
    for c, p in zip(chrs, pos):
        got[c][p] = True
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert all(enum.get_id(v) != INVALID_VERTEX for v in junc)


@pytest.mark.parametrize("k", [101, 311])
def test_large_k_golden_input(tmp_path, k):
    jcfg = JaxConfig(k=k, filter_bits=20, positions_per_row=256, rows_per_batch=4)
    jb, tb, enum = _both(tmp_path, jcfg, paths=[os.path.join(GOLDEN, "largek.fa")])
    assert jb == tb and enum.vertices_count > 0


def test_abundance_byte_identical(tmp_path):
    seqs = _genomes(5, n=6)
    sequences = [(i, jdna.encode(s)) for i, s in enumerate(seqs)]
    outs = []
    for ab in (3, (1 << 64) - 1):
        jcfg = JaxConfig(k=11, abundance=ab, positions_per_row=256, rows_per_batch=4)
        jb, tb, enum = _both(tmp_path, jcfg, sequences=sequences)
        assert jb == tb
        outs.append((tb, enum.vertices_count))
    assert outs[0][1] < outs[1][1]  # the limit dropped junctions


def _tiny_fasta(tmp_path):
    path = tmp_path / "tiny.fa"
    with open(path, "w") as f:
        for i, s in enumerate(_genomes(9, length=900, n=3)):
            f.write(f">s{i} genome {i}\n{s[:450]}\n{s[450:]}\n")
    return str(path)


def test_cli_byte_identical(tmp_path):
    fa = _tiny_fasta(tmp_path)
    tout, jout = str(tmp_path / "port.dbg"), str(tmp_path / "jax.dbg")
    assert port_main(["-k", "25", "-f", "20", "--device", "cpu", fa, "-o", tout]) == 0
    assert jax_main(["-k", "25", "-f", "20", fa, "-o", jout]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()


def test_cli_multi_round_exits_1(tmp_path, capsys):
    fa = _tiny_fasta(tmp_path)
    rc = port_main(["-k", "25", "-f", "20", "-r", "2", "--device", "cpu", fa,
                    "-o", str(tmp_path / "x.dbg")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "-r 2" in err and "multi-round" in err


def test_cli_rejects_bad_flags(tmp_path):
    fa = _tiny_fasta(tmp_path)
    assert port_main(["-k", "24", "-f", "20", "--device", "cpu", fa]) == 1
    assert port_main(["-k", "25", "--device", "cpu", fa]) == 1  # no -f
    assert port_main(["-k", "25", "-f", "20", "--device", "cpu"]) == 1


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fa = _tiny_fasta(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        build_junctions_sorted(
            [fa], config_from_jax(JaxConfig(k=25)), str(tmp_path / "x.dbg"),
            device="cuda",
        )
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["-k", "25", "-f", "20", fa, "-o", str(tmp_path / "x.dbg")])
    assert not os.path.exists(tmp_path / "x.dbg")
