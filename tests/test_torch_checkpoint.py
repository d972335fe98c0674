"""Round-boundary checkpoint and resume of the port (the model is
tests/test_checkpoint.py of the JAX package), on the CPU: a resumed run
writes the same bytes as the JAX package; a complete checkpoint skips the
partition pass; a partial one recomputes only its missing rounds; a
changed input, config or checkpoint format clears the directory."""

import os

import numpy as np
import pytest

from twopaco_tpu import dna as jdna
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.io import junctions
from twopaco_tpu_torch.passes import partition
from twopaco_tpu_torch.passes.pipeline import config_from_jax
from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted


def _seqs(seed, length=1500, n=2):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(n - 1)]
    return [(i, jdna.encode(s)) for i, s in enumerate(seqs)]


def _jcfg(k=9, rounds=3):
    return JaxConfig(k=k, filter_bits=20, rounds=rounds, positions_per_row=128,
                     rows_per_batch=4)


def _run(tmp_path, name, seqs, ck, k=9, rounds=3, paths=None):
    out = str(tmp_path / name)
    logs = []
    build_junctions_sorted(
        paths, config_from_jax(_jcfg(k, rounds)), out, sequences=seqs,
        log=logs.append, checkpoint_dir=ck, device="cpu",
    )
    return open(out, "rb").read(), logs


def _restored(logs):
    return sum("restored from checkpoint" in line for line in logs)


def _spy_partition(monkeypatch):
    calls = []
    fn = partition.partition_batch_plain

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(partition, "partition_batch_plain", spy)
    return calls


@pytest.fixture(scope="module")
def seqs():
    return _seqs(77)


@pytest.fixture(scope="module")
def jax_dbg(seqs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "jax.dbg")
    build_junctions(None, _jcfg(), out_path=out, sequences=seqs)
    return open(out, "rb").read()


def test_resume_byte_identical(tmp_path, seqs, jax_dbg):
    ck = str(tmp_path / "ck")
    first, logs = _run(tmp_path, "a.dbg", seqs, ck)
    assert first == jax_dbg and _restored(logs) == 0
    assert {f for f in os.listdir(ck) if f.startswith("round_")} == {
        f"round_{r}.npz" for r in range(3)
    }
    second, logs = _run(tmp_path, "b.dbg", seqs, ck)
    assert _restored(logs) == 3 and second == jax_dbg


def test_complete_checkpoint_skips_partition(tmp_path, monkeypatch, seqs, jax_dbg):
    ck = str(tmp_path / "ck")
    _run(tmp_path, "a.dbg", seqs, ck)
    calls = _spy_partition(monkeypatch)
    got, logs = _run(tmp_path, "b.dbg", seqs, ck)
    assert any("skipping partition" in line for line in logs), logs
    assert not calls and _restored(logs) == 3 and got == jax_dbg

    # a partial checkpoint partitions again and recomputes the lost round
    os.remove(os.path.join(ck, "round_1.npz"))
    got, logs = _run(tmp_path, "c.dbg", seqs, ck)
    assert not any("skipping partition" in line for line in logs)
    assert calls and _restored(logs) == 2 and got == jax_dbg


def test_grouped_resume(tmp_path, monkeypatch, seqs, jax_dbg):
    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "1")
    ck = str(tmp_path / "ck")
    first, logs = _run(tmp_path, "a.dbg", seqs, ck)
    assert any("resident groups" in line for line in logs)
    calls = _spy_partition(monkeypatch)
    second, logs = _run(tmp_path, "b.dbg", seqs, ck)
    assert _restored(logs) == 3 and not calls  # every group fully restored
    assert first == second == jax_dbg


def test_changed_input_invalidates(tmp_path, seqs):
    ck = str(tmp_path / "ck")
    _run(tmp_path, "a.dbg", seqs, ck)
    other = _seqs(78)
    got, logs = _run(tmp_path, "b.dbg", other, ck)
    assert _restored(logs) == 0
    fresh, _ = _run(tmp_path, "c.dbg", other, None)
    assert got == fresh

    # a FASTA file rewritten in place (another size, whatever the mtime
    # granularity)
    fa = tmp_path / "g.fa"
    fa.write_text(">a\n" + "".join("ACGTN"[c] for c in seqs[0][1]) + "\n")
    _run(tmp_path, "d.dbg", None, ck, paths=[str(fa)])
    fa.write_text(">a\n" + "".join("ACGTN"[c] for c in other[0][1][:-7]) + "\n")
    got, logs = _run(tmp_path, "e.dbg", None, ck, paths=[str(fa)])
    assert _restored(logs) == 0
    assert got == _run(tmp_path, "f.dbg", None, None, paths=[str(fa)])[0]


def test_config_change_invalidates(tmp_path):
    rng = np.random.default_rng(79)
    text = oracle.generate_sequence(rng, 1200)
    seqs = [(0, jdna.encode(text))]
    ck = str(tmp_path / "ck")
    _run(tmp_path, "a.dbg", seqs, ck, k=9)
    _got, logs = _run(tmp_path, "b.dbg", seqs, ck, k=7)
    assert _restored(logs) == 0
    _junc, want = oracle.find_junctions_naively([text], 7)
    _c, pos, _ids = junctions.read_junctions(str(tmp_path / "b.dbg"))
    marks = np.zeros(len(text), bool)
    marks[pos] = True
    np.testing.assert_array_equal(marks, want[0])


def test_jax_checkpoint_is_cleared(tmp_path, seqs, jax_dbg):
    """A twopaco_tpu checkpoint in the directory (4-byte packed rounds)
    is cleared, never read as the port's."""
    ck = str(tmp_path / "ck")
    build_junctions(None, _jcfg(), out_path=str(tmp_path / "j.dbg"),
                    sequences=seqs, checkpoint_dir=ck)
    got, logs = _run(tmp_path, "a.dbg", seqs, ck)
    assert _restored(logs) == 0 and got == jax_dbg
    got, logs = _run(tmp_path, "b.dbg", seqs, ck)
    assert _restored(logs) == 3 and got == jax_dbg
