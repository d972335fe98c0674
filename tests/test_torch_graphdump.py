"""The port's graphdump (twopaco_tpu_torch/formats/graphdump.py and its
CLI) against the reference graphdump binary's goldens and the JAX
package's graphdump. Text output: every comparison is byte for byte.

The goldens: tests/golden/largek_k{101,129,311,603}.* are the reference
graphdump's six formats of the reference constructor's .dbg on
tests/golden/largek.fa (as tests/test_large_k.py checks the JAX package);
tests/golden/example_k11.* its formats of example_k11.dbg on the
reference's example.fa, which tests/golden/example.fa rebuilds
(tests/test_torch_golden_example.py).
"""

import io
import os

import numpy as np
import pytest

from twopaco_tpu.formats import graphdump as jgd
from twopaco_tpu_torch.cli import graphdump as cli
from twopaco_tpu_torch.cli import twopaco
from twopaco_tpu_torch.formats import graphdump as gd
from twopaco_tpu_torch.testing import oracle

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
LK_FA = os.path.join(GOLD, "largek.fa")
EXAMPLE_FA = os.path.join(GOLD, "example.fa")
FORMATS = ["seq", "group", "dot", "gfa1", "gfa2", "fasta"]


def _golden(name: str) -> str:
    with open(os.path.join(GOLD, name)) as fh:
        return fh.read()


def _render(mod, fmt, dbg, genomes, k, prefix=False) -> str:
    """The text of one format from a graphdump module (the port's or the
    JAX package's)."""
    buf = io.StringIO()
    if fmt == "seq":
        mod.generate_seq(dbg, buf)
    elif fmt == "group":
        mod.generate_group(dbg, buf)
    elif fmt == "dot":
        mod.generate_dot(dbg, buf)
    elif fmt in ("gfa1", "gfa2"):
        mod.generate_gfa(dbg, genomes, k, buf, version=int(fmt[-1]), prefix=prefix)
    else:
        mod.generate_fasta(dbg, genomes, k, buf)
    return buf.getvalue()


@pytest.mark.parametrize("k", [101, 129, 311, 603])
@pytest.mark.parametrize("fmt", FORMATS)
def test_large_k_goldens(k, fmt):
    """All six formats of the reference's .dbg at k = 101 .. 603 (4 to 38
    words a k-mer) equal the reference graphdump's bytes."""
    got = _render(gd, fmt, os.path.join(GOLD, f"largek_k{k}.dbg"), [LK_FA], k)
    assert got == _golden(f"largek_k{k}.{fmt}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_example_goldens(fmt):
    """The reference example at k = 11 on tests/golden/example.fa: every
    format equals the reference graphdump's bytes. GFA1 names each input
    sequence's file in its S lines: the golden names the reference run's
    path, the port's run this one, and nothing else differs."""
    want = _golden(f"example_k11.{fmt}")
    if fmt == "gfa1":
        ref_path = want.splitlines()[1].split("UR:Z:")[1]
        want = want.replace(f"UR:Z:{ref_path}\n", f"UR:Z:{EXAMPLE_FA}\n")
    got = _render(gd, fmt, os.path.join(GOLD, "example_k11.dbg"), [EXAMPLE_FA], 11)
    assert got == want


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name} some description\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i : i + 60] + "\n")


@pytest.fixture(scope="module")
def port_dbg(tmp_path_factory):
    """A .dbg that the port's CLI wrote with --device cpu (k = 11, the
    Bloom engine, two rounds) from two FASTA files of related genomes with
    N runs, lowercase chars and ambiguity letters (reserved segment ids
    and 'N'-spelled reverse complements), and a sequence shorter than k."""
    rng = np.random.default_rng(7)
    base = oracle.generate_sequence(rng, 1500)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(3)]
    seqs[1] = seqs[1][:300] + "YRK" + seqs[1][303:700] + "acgtn" + seqs[1][705:]
    seqs[2] = seqs[2][:500] + "NNNNNNNNNNNNNN" + seqs[2][514:]
    d = tmp_path_factory.mktemp("port_dbg")
    fa1, fa2 = str(d / "a.fa"), str(d / "b.fa")
    _write_fasta(fa1, [("g0", seqs[0]), ("g1", seqs[1])])
    _write_fasta(fa2, [("short", "ACGTACG"), ("g2", seqs[2]), ("g3", seqs[3])])
    out = str(d / "port.dbg")
    rc = twopaco.main(["-k", "11", "-f", "20", "-r", "2", "--tpu-engine", "bloom",
                       "--device", "cpu", fa1, fa2, "-o", out])
    assert rc == 0 and os.path.getsize(out) > 0
    return out, [fa1, fa2]


@pytest.mark.parametrize("fmt,prefix", [(f, False) for f in FORMATS]
                         + [("gfa1", True), ("gfa2", True)])
def test_equals_jax_graphdump(port_dbg, capsys, fmt, prefix):
    """On a .dbg of the port, two FASTA files (-s twice) and --prefix: the
    port's graphdump writes the JAX package's text."""
    dbg, genomes = port_dbg
    capsys.readouterr()
    got = _render(gd, fmt, dbg, genomes, 11, prefix)
    assert got == _render(jgd, fmt, dbg, genomes, 11, prefix) and got


def test_cli(capsys, tmp_path):
    """python -m twopaco_tpu_torch.cli.graphdump: the golden through the
    CLI's flags; a GFA without -s exits 1."""
    dbg = os.path.join(GOLD, "largek_k101.dbg")
    assert cli.main(["-f", "gfa2", "-k", "101", "-s", LK_FA, "--prefix", dbg]) == 0
    buf = io.StringIO()
    gd.generate_gfa(dbg, [LK_FA], 101, buf, version=2, prefix=True)
    assert capsys.readouterr().out == buf.getvalue()
    assert cli.main(["-k", "101", dbg]) == 0  # seq, the default format
    assert capsys.readouterr().out == _golden("largek_k101.seq")
    assert cli.main(["-f", "gfa1", "-k", "101", dbg]) == 1
    assert "seqfilename" in capsys.readouterr().err
