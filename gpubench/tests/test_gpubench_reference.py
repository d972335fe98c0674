"""The plain reference against the program's .dbg (its plain versions on
the CPU, --device cpu) on small inputs, and its control failing the
comparison."""

import contextlib
import io

import numpy as np
import pytest

from gpubench import control, genome, reference
from twopaco_tpu_torch.cli import twopaco


def _program_dbg(fa, out, k, rounds=1):
    with contextlib.redirect_stdout(io.StringIO()):
        rc = twopaco.main(["-k", str(k), "-r", str(rounds), "-f", "20", "--device", "cpu",
                           str(fa), "-o", str(out)])
    assert rc == 0
    return np.fromfile(out, dtype=np.uint8)


def _odd_fasta(path, seqs, k):
    """The sequences plus edge cases: one shorter than k, one of exactly
    k, N at both ends, lowercase and a body over several lines."""
    extra = [b"ACGTNACG"[: max(1, k - 1)], bytes(seqs[0][:k]), b"N" + bytes(seqs[0][:300]) + b"N",
             bytes(seqs[-1][:500]).lower()]
    with open(path, "wb") as f:
        for i, s in enumerate([bytes(s) for s in seqs] + extra):
            f.write(f">s{i} description\n".encode())
            for a in range(0, len(s), 61):
                f.write(s[a : a + 61] + b"\n")


@pytest.mark.parametrize("n,length,k,rounds", [
    (4, 3000, 25, 1), (1, 20000, 31, 4), (6, 2500, 11, 3), (3, 2000, 5, 1), (5, 4000, 25, 2),
])
def test_reference_equals_the_program(tmp_path, n, length, k, rounds):
    seqs = genome.make_bench_genomes(n, length, 0.02, 0.003, seed=n * 100 + k)
    fa = tmp_path / "in.fa"
    _odd_fasta(fa, seqs, k)
    got = _program_dbg(fa, tmp_path / "o.dbg", k, rounds)
    want, n_junc = reference.reference_dbg(str(fa), k)
    assert len(got) == len(want) and len(got) % 12 == 0
    assert reference.records_differing(got, want) == 0
    assert bytes(got) == bytes(want)
    if k >= 11:
        assert n_junc > 0


def test_records_differing():
    a = np.arange(120, dtype=np.uint8)
    assert reference.records_differing(a, a.copy()) == 0
    b = a.copy()
    b[13] += 1
    b[100] += 1
    assert reference.records_differing(b, a) == 2
    assert reference.records_differing(a[:96], a) == 2
    assert reference.records_differing(a[:95], a) == 11
    assert reference.records_differing(bytes(a), a) == 0


def test_parse_fasta_rejects_what_the_reference_does(tmp_path):
    p = tmp_path / "bad.fa"
    p.write_bytes(b">x\nACGTZ\n")
    with pytest.raises(ValueError, match="invalid character"):
        reference.parse_fasta(str(p))
    p.write_bytes(b">x\nAC GT\nryk\n>y\n\n")
    got = reference.parse_fasta(str(p))
    assert [list(c) for c in got] == [[0, 1, 2, 3, 4, 4, 4], []]


def test_control_fails_the_comparison(tmp_path):
    # the control at a size a test holds: 400,000 distinct 31-mers give
    # their 32-bit fingerprints ~19 collisions
    fa = tmp_path / "in.fa"
    genome.write_fasta(str(fa), genome.make_bench_genomes(1, 400_000, seed=5))
    want, _ = reference.reference_dbg(str(fa), 31)
    ctrl, _ = control.control_dbg(str(fa), 31)
    assert len(want) // 12 == 2  # the two stubs
    assert reference.records_differing(ctrl, want) > 3
