"""The port's packed merge on the device (passes/merge.py, the CPU
counterpart of kernels/csrc/merge.cu on sort.cu's passes) against its host
merge (sortpipe.merge_tables + packed_occurrences + a sort) on random
disjoint entries, and the .dbg of the sort and dist engines, whose
multi-entry merges now take it, against the JAX package's. Tolerance:
exact (tables, keys and .dbg bytes equal; the same errors raised)."""

import os

import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.io import fasta as jfasta
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.parallel import distpipe
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.passes import merge, sortpipe
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats, config_from_jax

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _entries(seed, n_entries, k, id_bits, n_slots=1 << 16, rows=300, occ=2000):
    """n_entries keyed entries of disjoint random k-mer tables (sorted),
    each with position-sorted keys of unique positions and ids +-(1 ..
    its table)."""
    rng = np.random.default_rng(seed)
    w = -(-k // 16)
    words = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    words[:, -1] &= np.uint32(pack.last_word_mask(k))
    words = np.unique(words, axis=0)  # sorted, distinct
    owner = rng.integers(0, n_entries, size=len(words))
    pos = rng.choice(n_slots, size=occ, replace=False).astype(np.int64)
    pos_owner = rng.integers(0, n_entries, size=occ)
    bias = 1 << (id_bits - 1)
    fetched = []
    for e in range(n_entries):
        table = np.ascontiguousarray(words[owner == e])
        p = np.sort(pos[pos_owner == e]) if len(table) else np.zeros(0, np.int64)
        ids = rng.integers(1, len(table) + 1, size=len(p)) * rng.choice([-1, 1], size=len(p))
        keys = ((p.astype(np.uint64) << np.uint64(id_bits))
                | (ids + bias).astype(np.uint64))
        fetched.append((table, OccKeys(keys, id_bits), None))
    return fetched


def _host(fetched, w, pos_bits):
    table, inv = sortpipe.merge_tables(fetched, w)
    buf = sortpipe.packed_occurrences(fetched, inv, pos_bits)
    buf.sort(kind="stable")
    return table, buf


@pytest.mark.parametrize("n_entries", [1, 2, 5])
@pytest.mark.parametrize("pos_bits", [32, 40])
@pytest.mark.parametrize("k", [11, 25, 101])
def test_merge_packed_plain_matches_host(n_entries, pos_bits, k):
    """Exact: the global table and the sorted keys of the host merge."""
    id_bits = 64 - pos_bits
    fetched = _entries(n_entries * 100 + k, n_entries, k, id_bits)
    want_t, want_k = _host(fetched, -(-k // 16), pos_bits)
    cfg = PipelineConfig(k=k)
    got_t, got_k = sortpipe.merge_on_device(fetched, cfg, id_bits, CPU, reference=False)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_k, want_k)
    assert got_k.dtype == np.uint64 and len(got_k) == sum(len(e[1]) for e in fetched)
    # the plain composition directly (any device), on fresh concatenations
    tab = torch.from_numpy(np.concatenate([e[0] for e in fetched]))
    keys = torch.from_numpy(np.concatenate([e[1].keys for e in fetched]).view(np.int64))
    ofs = np.cumsum([[0] + [len(e[1]) for e in fetched], [0] + [len(e[0]) for e in fetched]],
                    axis=1)
    gt, gk, faults = merge.merge_packed_plain(tab, keys, torch.from_numpy(ofs), key_bits=2 * k,
                                              id_bits=id_bits)
    np.testing.assert_array_equal(pack.as_i64(gt).numpy().astype(np.uint32), want_t)
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), want_k)
    assert faults.tolist() == [0, 0, 0]


def _corrupt(fetched, what, id_bits):
    """A copy of the entries with one fault in entry 0 (a k-mer of entry
    1's table added, or a key's id set to 0 or past entry 0's table)."""
    out = [(t.copy(), OccKeys(k.keys.copy(), k.id_bits), n) for t, k, n in fetched]
    table, keys, _ = out[0]
    if what == "duplicate":
        both = np.concatenate([table, fetched[1][0][:1]])
        out[0] = (both[np.lexsort(both.T[::-1])], keys, None)
    else:
        bad = 0 if what == "id 0" else len(table) + 1
        mask = np.uint64((1 << id_bits) - 1)
        keys.keys[0] = (keys.keys[0] & ~mask) | np.uint64(bad + (1 << (id_bits - 1)))
    return out


FAULTS = {"duplicate": (AssertionError, "duplicate junction keys"),
          "id 0": (RuntimeError, "occurrence id 0"),
          "past": (RuntimeError, "occurrence id out of range")}


@pytest.mark.parametrize("n_entries,what", [(1, "id 0"), (1, "past"), (3, "duplicate"),
                                             (3, "id 0"), (3, "past")])
@pytest.mark.parametrize("free", [None, 1])
def test_merge_faults_raise_as_the_host_merge(n_entries, what, free):
    """Exact: a duplicate k-mer across entries, an id 0 and an id past its
    table raise the host merge's errors on every path (one entry: its
    checks; N: the device merge, or the host merge by the size rule)."""
    fetched = _corrupt(_entries(17, max(n_entries, 2), 25, 32), what, 32)[:n_entries]
    batches = sortpipe.read_batches(None, [(0, np.zeros(40, np.uint8))],
                                    PipelineConfig(k=25), RunStats())[1]
    exc, msg = FAULTS[what]
    with pytest.raises(exc, match=msg):
        sortpipe.merge_rounds_packed(fetched, batches, PipelineConfig(k=25), None, RunStats(),
                                     print, 0.0, dev=CPU, free=free)


def _key_run(rounds):
    """The keyed entries and batches of a sort-engine run on the CPU."""
    got = {}

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=fetched, batches=batches)

    orig = sortpipe.merge_fetched
    sortpipe.merge_fetched = capture
    try:
        sortpipe.build_junctions_sorted(None, PipelineConfig(k=11, rounds=rounds,
                                                             positions_per_row=256,
                                                             rows_per_batch=4),
                                        None, sequences=_genomes(123), device="cpu")
    finally:
        sortpipe.merge_fetched = orig
    return got["fetched"], got["batches"]


def test_small_free_memory_takes_the_host_merge(tmp_path, monkeypatch):
    """Exact: with a free-memory figure below the device merge's buffers
    the host merge runs (and says so), and writes the device merge's
    bytes."""
    fetched, batches = _key_run(3)
    cfg = PipelineConfig(k=11, positions_per_row=256)
    kw = dict(n_slots=len(batches) * 4 * 256, wide=False, n_sequences=4, dev=CPU)
    lines = []
    out_d, out_h = str(tmp_path / "d.dbg"), str(tmp_path / "h.dbg")
    sortpipe.merge_fetched(fetched, batches, cfg, out_d, RunStats(), lines.append, 0.0,
                           free=None, **kw)
    assert not any("Merge on the host" in s for s in lines)

    def refuse(*_a, **_kw):
        raise AssertionError("the device merge ran")

    monkeypatch.setattr(merge, "merge_packed", refuse)
    sortpipe.merge_fetched(fetched, batches, cfg, out_h, RunStats(), lines.append, 0.0,
                           free=1, **kw)
    assert any("Merge on the host" in s for s in lines)
    assert open(out_h, "rb").read() == open(out_d, "rb").read()


def _genomes(seed, length=2500, n=4):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [(i, jdna.encode(s)) for i, s in enumerate(
        [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(n - 1)])]


INPUTS = {
    "example": lambda: [(sid, c) for sid, _h, c in jfasta.read_all_records(
        [os.path.join(GOLDEN, "example.fa")])],
    "genomes": lambda: _genomes(123),
}
RUNS = ("sort_r1", "sort_r3", "sort_r4", "dist_2", "dist_4")


@pytest.fixture(scope="module")
def jax_bytes(tmp_path_factory):
    out = {}
    for name, make in INPUTS.items():
        path = str(tmp_path_factory.mktemp("jax") / f"{name}.dbg")
        build_junctions(None, JaxConfig(k=11, filter_bits=20, positions_per_row=256,
                                        rows_per_batch=4), out_path=path, sequences=make())
        out[name] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_dbg_matches_jax(tmp_path, monkeypatch, jax_bytes, name, run):
    """Exact: the .dbg of sort -r 1, 3, 4 and of the dist engine over 2 and
    4 CPU shards equals the JAX package's; a run of N keyed entries merges
    through passes/merge.py (no host table sort or remap), one entry
    through neither."""
    calls = []
    orig = merge.merge_packed
    monkeypatch.setattr(merge, "merge_packed", lambda *a, **kw: calls.append(1) or orig(*a, **kw))

    def refuse(*_a, **_kw):
        raise AssertionError("host merge of keyed entries that fit")

    monkeypatch.setattr(sortpipe, "merge_tables", refuse)
    monkeypatch.setattr(sortpipe, "packed_occurrences", refuse)
    cfg = config_from_jax(JaxConfig(k=11, filter_bits=20, positions_per_row=256,
                                    rows_per_batch=4, rounds=int(run[-1]) if "sort" in run
                                    else 1))
    out = str(tmp_path / "o.dbg")
    if run.startswith("sort"):
        sortpipe.build_junctions_sorted(None, cfg, out, sequences=INPUTS[name](), device="cpu")
    else:
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * int(run[-1])), out,
                                      sequences=INPUTS[name](), device="cpu")
    assert open(out, "rb").read() == jax_bytes[name]
    assert len(calls) == (0 if run == "sort_r1" else 1)
