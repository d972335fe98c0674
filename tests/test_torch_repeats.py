"""The port's sort engine on a repeat-bearing sequence, against the plain
reference.

One seeded base of 0.5 Mbase carries the four interspersed repeat
families of the benchmark's chr1 configuration (gpubench/configs/chr1.json):
k-mers that recur in many copies on both strands, so that junction groups
are large and mix the strands. The port's CLI (--device cpu, the plain
versions of every kernel) builds it at k = 31 and 25, in one round and in
four; its .dbg must equal gpubench.reference.junction_records byte for
byte, and the counters a build prints (the judge spans' records,
junctions and occurrences, the build's group_max) must agree with the
reference's counts.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import genome, reference
from twopaco_tpu_torch.cli import twopaco

CHR1 = json.loads((Path(__file__).resolve().parent.parent / "gpubench" / "configs"
                   / "chr1.json").read_text())
LENGTH = 500_000
SEED = 2**31 + 23


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("repeats") / "chr1_part.fa"
    genome.write_fasta(str(path), genome.config_genomes(dict(CHR1, length=LENGTH), SEED))
    return str(path)


_REFS: dict = {}


def _reference(fasta: str, k: int) -> dict:
    """The reference's .dbg bytes and counts for k (one per k a process)."""
    if k not in _REFS:
        codes = reference.parse_fasta(fasta)
        rows, n_junc = reference.junction_records(codes, k)
        dbg = rows.numpy().view(np.uint8).reshape(-1)
        occurrences, most = reference.occurrences(dbg, n_junc)
        records = sum(reference.vertices(torch.from_numpy(c).to(torch.int64), k)[0].numel()
                      for c in codes if len(c) >= k)
        _REFS[k] = dict(dbg=dbg, junctions=n_junc, occurrences=occurrences, most=most,
                        records=records)
    return _REFS[k]


def _counters(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        parts = line.split("\t")
        if len(parts) == 4 and parts[0] == "counter":
            out[(parts[1], parts[2])] = int(float(parts[3]))
    return out


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("k", [31, 25])
def test_sort_engine_on_repeats_equals_reference(fasta, tmp_path, k, rounds):
    want = _reference(fasta, k)
    ids = want["dbg"].view(np.dtype([("pos", "<u4"), ("id", "<i8")]))["id"]
    ids = ids[(ids != 0) & (np.abs(ids) <= want["junctions"])]
    # the input holds junction k-mers read on both strands, and a junction
    # of many occurrences
    plus = np.bincount(ids[ids > 0], minlength=want["junctions"] + 1)
    minus = np.bincount(-ids[ids < 0], minlength=want["junctions"] + 1)
    assert np.count_nonzero((plus > 0) & (minus > 0)) > want["junctions"] // 4
    hot = int(np.argmax(plus + minus))
    assert plus[hot] > 0 and minus[hot] > 0
    assert want["most"] >= 20, want["most"]

    out_path = tmp_path / "out.dbg"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = twopaco.main(["-k", str(k), "-f", "20", "-r", str(rounds), "--device", "cpu",
                           fasta, "-o", str(out_path)])
    assert rc in (0, None)
    got = np.frombuffer(out_path.read_bytes(), dtype=np.uint8)
    assert reference.records_differing(got, want["dbg"]) == 0
    assert got.tobytes() == want["dbg"].tobytes()

    log = stdout.getvalue()
    n_rounds = sum(ln.startswith("Round ") and "seconds" in ln for ln in log.splitlines())
    assert n_rounds >= rounds
    counters = _counters(log)
    assert counters[("judge", "records")] == want["records"]
    assert counters[("judge", "junctions")] == want["junctions"]
    assert counters[("judge", "occurrences")] == want["occurrences"]
    assert counters[("total", "group_max")] >= want["most"]
