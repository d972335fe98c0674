"""The port's packed merge on the device (passes/merge.py, the CPU
counterpart of kernels/csrc/merge.cu: merge_rows and merge_keys) against
its host merge (sortpipe.merge_tables + packed_occurrences + a sort) on
random disjoint entries (range-partitioned as dist shards give them, empty
tables, entries with no keys), the kernels' split arithmetic
(merge_splits_plain) against an argsort of the concatenation, the size
rule against the buffers, and the .dbg of the sort and dist engines, whose
multi-entry merges take it, against the JAX package's. Tolerance: exact
(tables, keys, splits and .dbg bytes equal; the same errors raised)."""

import dataclasses
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
from twopaco_tpu_torch.passes import emit, merge, sortpipe
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats, config_from_jax
from twopaco_tpu_torch.passes.versions import KERNELS

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _entries(seed, n_entries, k, id_bits, n_slots=1 << 16, rows=300, occ=2000,
             layout="random"):
    """n_entries keyed entries of disjoint random k-mer tables (sorted),
    each with position-sorted keys of unique positions and ids +-(1 ..
    its table). layout "ranges": each entry a contiguous range of the
    k-mers, as the dist shards' entries are; "sparse": every third entry's
    table empty (entry 0 on), and entry 1 holds no keys."""
    rng = np.random.default_rng(seed)
    w = -(-k // 16)
    words = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    words[:, -1] &= np.uint32(pack.last_word_mask(k))
    words = np.unique(words, axis=0)  # sorted, distinct
    owner = rng.integers(0, n_entries, size=len(words))
    if layout == "ranges":
        owner = np.sort(owner)
    elif layout == "sparse":
        owner = rng.choice([e for e in range(n_entries) if e % 3], size=len(words))
    pos = rng.choice(n_slots, size=occ, replace=False).astype(np.int64)
    pos_owner = rng.integers(0, n_entries, size=occ)
    bias = 1 << (id_bits - 1)
    fetched = []
    for e in range(n_entries):
        table = np.ascontiguousarray(words[owner == e])
        keyless = layout == "sparse" and e == 1
        p = np.sort(pos[pos_owner == e]) if len(table) and not keyless else np.zeros(0, np.int64)
        ids = rng.integers(1, len(table) + 1, size=len(p)) * rng.choice([-1, 1], size=len(p))
        keys = ((p.astype(np.uint64) << np.uint64(id_bits))
                | (ids + bias).astype(np.uint64))
        fetched.append((table, OccKeys(torch.from_numpy(keys.view(np.int64)), id_bits), None))
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
    got_t, got_k = sortpipe.merge_on_device(fetched, cfg, id_bits, CPU, KERNELS)
    # the keys stay on the merge's device, int64-held u64
    assert got_k.dtype == torch.int64 and got_k.device == CPU
    assert got_k.numel() == sum(len(e[1]) for e in fetched)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint64), want_k)
    # the plain composition directly (any device), on fresh concatenations
    tab = torch.from_numpy(np.concatenate([e[0] for e in fetched]))
    keys = torch.cat([e[1].keys for e in fetched])
    ofs = np.cumsum([[0] + [len(e[1]) for e in fetched], [0] + [len(e[0]) for e in fetched]],
                    axis=1)
    gt, gk, faults = merge.merge_packed_plain(tab, keys, torch.from_numpy(ofs), key_bits=2 * k,
                                              id_bits=id_bits)
    np.testing.assert_array_equal(pack.as_i64(gt).numpy().astype(np.uint32), want_t)
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), want_k)
    assert faults.tolist() == [0, 0, 0]


def _cat(fetched):
    """The entries as merge_packed takes them: (table, keys, entries)."""
    tab = torch.from_numpy(np.concatenate([e[0] for e in fetched]))
    keys = torch.cat([e[1].keys for e in fetched])
    ofs = np.cumsum([[0] + [len(e[1]) for e in fetched], [0] + [len(e[0]) for e in fetched]],
                    axis=1)
    return tab, keys, torch.from_numpy(ofs)


def _check_rows_and_keys(fetched, k, pos_bits):
    """merge_rows_plain and merge_keys_plain against the host merge: its
    global table, its inv, its sorted keys; no fault."""
    id_bits = 64 - pos_bits
    want_t, want_inv = sortpipe.merge_tables(fetched, -(-k // 16))
    want_k = sortpipe.packed_occurrences(fetched, want_inv, pos_bits)
    want_k.sort(kind="stable")
    tab, keys, ent = _cat(fetched)
    gt, inv, dup = merge.merge_rows_plain(tab, ent[1])
    np.testing.assert_array_equal(pack.as_i64(gt).numpy().astype(np.uint32), want_t)
    np.testing.assert_array_equal(inv.numpy(), want_inv)
    assert inv.dtype == torch.int32 and dup.tolist() == [0]
    gk, faults = merge.merge_keys_plain(keys, ent, inv, id_bits=id_bits)
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), want_k)
    assert faults.tolist() == [0, 0]
    # the keys as they came: a new tensor is written
    np.testing.assert_array_equal(keys.numpy().view(np.uint64),
                                  np.concatenate([e[1].host() for e in fetched]))


@pytest.mark.parametrize("n_entries", [2, 5, 16, 40])
@pytest.mark.parametrize("pos_bits", [32, 40])
@pytest.mark.parametrize("k", [11, 25, 101])
def test_merge_rows_and_keys_plain_match_host(n_entries, pos_bits, k):
    """Exact: the global table, inv and the keys of the host merge, for as
    many entries as a dist -r run hands the merge (16, 40: past FAN_IN)."""
    fetched = _entries(n_entries * 1000 + k + pos_bits, n_entries, k, 64 - pos_bits,
                       rows=40 * n_entries)
    _check_rows_and_keys(fetched, k, pos_bits)


@pytest.mark.parametrize("layout", ["ranges", "sparse"])
@pytest.mark.parametrize("n_entries", [3, 16, 40])
def test_merge_plain_edge_entries(layout, n_entries):
    """Exact: range-partitioned entries (the tables already in global
    order), empty tables and entries with no keys; and the same through
    sortpipe.merge_on_device."""
    fetched = _entries(7 + n_entries, n_entries, 25, 32, rows=30 * n_entries, layout=layout)
    if layout == "sparse":
        assert any(len(e[0]) == 0 for e in fetched)
        assert any(len(e[0]) and not len(e[1]) for e in fetched)
    _check_rows_and_keys(fetched, 25, 32)
    want_t, want_k = _host(fetched, 2, 32)
    got_t, got_k = sortpipe.merge_on_device(fetched, PipelineConfig(k=25), 32, CPU, KERNELS)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint64), want_k)


def _runs(rng, n_runs, layout):
    """Sorted int64 runs of random lengths (some empty), concatenated, and
    their offsets: random values, disjoint ranges, or few values (equal
    elements across runs)."""
    lens = rng.integers(0, 60, size=n_runs)
    lens[rng.random(n_runs) < 0.2] = 0
    runs = []
    for f, n in enumerate(lens):
        if layout == "ranges":
            runs.append(np.arange(n, dtype=np.int64) + 1000 * f)
        else:
            runs.append(np.sort(rng.integers(0, 40 if layout == "dups" else 1 << 40, size=n)))
    return np.concatenate(runs).astype(np.int64), np.concatenate([[0], np.cumsum(lens)])


@pytest.mark.parametrize("layout", ["random", "ranges", "dups"])
@pytest.mark.parametrize("tile", [1, 3, 8, 64, 2048])
@pytest.mark.parametrize("n_runs", [1, 2, 5, 16, 32])
def test_merge_splits_plain_against_argsort(n_runs, tile, layout):
    """Exact: at every tile boundary the window (L, U) of each run is the
    one its samples' ranks in the stable argsort of the concatenation give,
    and holds the run's true split, within S - 1 (tiles of 1: every rank a
    boundary, so splits fall on every run end)."""
    rng = np.random.default_rng(n_runs * 100 + tile)
    vals, ofs = _runs(rng, n_runs, layout)
    got = merge.merge_splits_plain(torch.from_numpy(vals), torch.from_numpy(ofs),
                                   tile=tile).numpy()
    n = len(vals)
    S = merge.sample_stride(tile, n_runs)
    order = np.argsort(vals, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    run_of = np.repeat(np.arange(n_runs), np.diff(ofs))
    bounds = np.minimum(np.arange(-(-n // tile) + 1) * tile, n)
    assert got.shape == (len(bounds), n_runs, 2)
    for f in range(n_runs):
        length = ofs[f + 1] - ofs[f]
        samples = rank[ofs[f] : ofs[f + 1]][::S]
        for t, b in enumerate(bounds):
            split = int((run_of[order[:b]] == f).sum())
            m = int((samples < b).sum())
            want = ((m - 1) * S + 1 if m else 0, m * S if m < len(samples) else length)
            assert tuple(got[t, f]) == want, (f, t)
            assert want[0] <= split <= want[1] and want[1] - want[0] <= max(S - 1, 0)


@pytest.mark.parametrize("n_entries", [2, 16, 40])
def test_device_bytes_counts_the_merge_buffers(n_entries):
    """Exact: merge.buffers counts the bytes of the tensors a merge holds:
    the inputs, merge_packed_plain's outputs and inv, the split tables
    (merge_splits_plain's, one group) and, past FAN_IN entries, the earlier
    rounds' outputs; device_bytes is their sum."""
    fetched = _entries(n_entries, n_entries, 25, 32, rows=40 * n_entries)
    tab, keys, ent = _cat(fetched)
    gt, gk, faults = merge.merge_packed_plain(tab, keys, ent, key_bits=50, id_bits=32)
    inv = merge.merge_rows_plain(tab, ent[1])[1]
    T, w = tab.shape
    got = merge.buffers(T, w, keys.numel(), n_entries)
    nb = lambda t: t.numel() * t.element_size()  # noqa: E731
    want = {"table": nb(tab), "table out": nb(gt), "inv": nb(inv), "keys": nb(keys),
            "keys out": nb(gk), "entries": nb(ent)}
    if n_entries <= merge.FAN_IN:
        want["row splits"] = nb(merge.merge_splits_plain(
            merge.row_values(tab), ent[1], tile=merge.default_tile(w)))
        want["key splits"] = nb(merge.merge_splits_plain(
            merge.key_values(keys, 32), ent[0], tile=merge.default_tile(2)))
    else:
        want.update({"table tmp": nb(tab), "inv tmp": nb(inv), "keys tmp": nb(keys)})
    assert {n: got[n] for n in want} == want
    assert set(got) - set(want) <= {"row splits", "key splits"}
    assert merge.device_bytes(T, w, keys.numel(), n_entries) == sum(got.values())
    assert faults.tolist() == [0, 0, 0]


def _corrupt(fetched, what, id_bits):
    """A copy of the entries with one fault in entry 0 (a k-mer of entry
    1's table added, or a key's id set to 0 or past entry 0's table)."""
    out = [(t.copy(), OccKeys(k.keys.clone(), k.id_bits), n) for t, k, n in fetched]
    table, keys, _ = out[0]
    if what == "duplicate":
        both = np.concatenate([table, fetched[1][0][:1]])
        out[0] = (both[np.lexsort(both.T[::-1])], keys, None)
    else:
        bad = 0 if what == "id 0" else len(table) + 1
        mask = np.uint64((1 << id_bits) - 1)
        ku = keys.keys.numpy().view(np.uint64)
        ku[0] = (ku[0] & ~mask) | np.uint64(bad + (1 << (id_bits - 1)))
    return out


FAULTS = {"duplicate": (AssertionError, "duplicate junction keys"),
          "id 0": (RuntimeError, "occurrence id 0"),
          "past": (RuntimeError, "occurrence id out of range")}


@pytest.mark.parametrize("n_entries,what", [(1, "id 0"), (1, "past"), (3, "duplicate"),
                                             (3, "id 0"), (3, "past")])
@pytest.mark.parametrize("free", [None, 1])
def test_merge_faults_raise_as_the_host_merge(n_entries, what, free):
    """Exact: a duplicate k-mer across entries, an id 0 and an id past its
    table raise the host merge's errors on every path (one entry: the
    emit's check, whose tables need more than a byte, so free=1 gives it
    its least, a chunk an occurrence; N: the device merge, or the host
    merge by the size rule)."""
    fetched = _corrupt(_entries(17, max(n_entries, 2), 25, 32), what, 32)[:n_entries]
    batches = sortpipe.read_batches(None, [(0, np.zeros(40, np.uint8))],
                                    PipelineConfig(k=25), RunStats())[1]
    if n_entries == 1 and free == 1:
        with pytest.raises(RuntimeError, match="tables need"):
            sortpipe.merge_rounds_packed(fetched, batches, PipelineConfig(k=25), None,
                                         RunStats(), print, dev=CPU, free=free)
        free = emit.table_bytes(batches) + 2 * 12
    exc, msg = FAULTS[what]
    with pytest.raises(exc, match=msg):
        sortpipe.merge_rounds_packed(fetched, batches, PipelineConfig(k=25), None, RunStats(),
                                     print, dev=CPU, free=free)


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


def test_small_free_memory_takes_the_host_merge(tmp_path):
    """Exact: with a free-memory figure below the device merge's buffers
    the host merge runs (and says so), and writes the device merge's
    bytes."""
    fetched, batches = _key_run(3)
    cfg = PipelineConfig(k=11, positions_per_row=256)
    kw = dict(n_slots=len(batches) * 4 * 256, wide=False, n_sequences=4, dev=CPU)
    lines = []
    out_d, out_h = str(tmp_path / "d.dbg"), str(tmp_path / "h.dbg")
    sortpipe.merge_fetched(fetched, batches, cfg, out_d, RunStats(), lines.append,
                           free=None, **kw)
    assert not any("Merge on the host" in s for s in lines)

    def refuse(*_a, **_kw):
        raise AssertionError("the device merge ran")

    sortpipe.merge_fetched(fetched, batches, cfg, out_h, RunStats(), lines.append,
                           free=1, ops=dataclasses.replace(KERNELS, merge=refuse), **kw)
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
    spy = dataclasses.replace(
        KERNELS, merge=lambda *a, **kw: calls.append(1) or KERNELS.merge(*a, **kw))
    monkeypatch.setattr(sortpipe, "KERNELS", spy)
    monkeypatch.setattr(distpipe, "KERNELS", spy)

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
