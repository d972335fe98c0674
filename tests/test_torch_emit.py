"""The emit of every packed merge (passes/emit.py) on CPU tensors,
through its plain versions: the bytes of the JAX package's packed emit
(twopaco_tpu pipeline.emit_junctions_packed) for the same keys and of its
build, faults raised before the output exists, the merge's choice of path
and its counters, and the round checkpoint's guard."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions as jax_build
from twopaco_tpu.passes import pipeline as jpipe
from twopaco_tpu_torch import trace
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.passes import emit, merge, pipeline, sortpipe
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats
from twopaco_tpu_torch.passes.versions import KERNELS
from twopaco_tpu_torch.testing import emit_cases

K, P, B = 11, 64, 4
REPO = Path(__file__).resolve().parent.parent


def _batches(kind, seed=3):
    return emit_cases.batches(emit_cases.lengths(kind, K), K, P, B, seed)


def _keys(batches, ends, id_bits, n_table):
    return emit_cases.keys(batches, P, id_bits, n_table, ends)


def _card_bytes(tmp_path, batches, keys, n_table, id_bits, chunk_occ, name="card.dbg"):
    out = str(tmp_path / name)
    kt = torch.from_numpy(keys.view(np.int64))
    found = emit.check_keys(kt, batches, n_table, P, id_bits, chunk_occ=chunk_occ)
    got = emit.write_keys(out, batches, kt, found, n_table, P, id_bits)
    return open(out, "rb").read(), got


def _host_bytes(tmp_path, batches, keys, n_table, id_bits):
    """The JAX package's packed emit's bytes and counts for the same
    keys."""
    out = str(tmp_path / "jax.dbg")
    n = jpipe.emit_junctions_packed(out, batches, keys, n_table, P, id_bits=id_bits)
    return open(out, "rb").read(), tuple(int(x) for x in n)


@pytest.mark.parametrize("chunk_occ", [1, 2, 3, 7, 1 << 24])
@pytest.mark.parametrize("ends", ["stubs", "none", "random"])
@pytest.mark.parametrize("lengths", ["mixed", "many"])
@pytest.mark.parametrize("id_bits", [32, 24])
def test_card_emit_writes_the_host_emits_bytes(tmp_path, id_bits, lengths, ends, chunk_occ):
    """Every chunk size from one occurrence a chunk (each chunk edge then
    falls after every stub and separator in turn) to one chunk."""
    batches = _batches(lengths)
    n_table = 900
    keys = _keys(batches, ends, id_bits, n_table)
    want, want_n = _host_bytes(tmp_path, batches, keys, n_table, id_bits)
    got, got_n = _card_bytes(tmp_path, batches, keys, n_table, id_bits, chunk_occ)
    assert got_n == want_n and got == want and len(want) % 12 == 0


@pytest.mark.parametrize("chunk_occ", [64, 1 << 24])
@pytest.mark.parametrize("ends", ["stubs", "random"])
def test_card_emit_of_long_stub_runs(tmp_path, ends, chunk_occ):
    """Thousands of one-position sequences in a row: runs of stubs and
    separators wider than a kernel block's stage."""
    batches = _batches("runs")
    keys = _keys(batches, ends, 32, 300)
    want, want_n = _host_bytes(tmp_path, batches, keys, 300, 32)
    got, got_n = _card_bytes(tmp_path, batches, keys, 300, 32, chunk_occ)
    assert got_n == want_n and got == want


@pytest.mark.parametrize("lengths", ["mixed", "many", "runs"])
@pytest.mark.parametrize("chunk_occ", [1, 5])
def test_card_emit_of_no_keys(tmp_path, lengths, chunk_occ):
    """No occurrence: stubs and separators only, in one chunk."""
    batches = _batches(lengths)
    keys = np.zeros(0, np.uint64)
    want, want_n = _host_bytes(tmp_path, batches, keys, 10, 32)
    got, got_n = _card_bytes(tmp_path, batches, keys, 10, 32, chunk_occ)
    assert got_n == want_n and got == want and want_n[1] > 0


def test_plan_chunks_tile_the_records(tmp_path):
    """Chunks cover consecutive occurrences and slots, end to end."""
    batches = _batches("mixed")
    keys = _keys(batches, "random", 32, 50)
    kt = torch.from_numpy(keys.view(np.int64))
    found = emit.check_keys(kt, batches, 50, P, 32, chunk_occ=4)
    pl = emit.plan(batches, found, len(keys), 50, P, 32)
    want, _n = _host_bytes(tmp_path, batches, keys, 50, 32)
    (i0, _, s0, _), (_, i1, _, s1) = pl.bounds[0], pl.bounds[-1]
    assert (i0, s0, i1, s1) == (0, 0, len(keys), len(want) // 12)
    for (_a, e, _s, t), (a2, _e2, s2, _t2) in zip(pl.bounds, pl.bounds[1:]):
        assert (e, t) == (a2, s2)


FAULTS = {
    "id 0": (0, "occurrence id 0"),
    "past": (51, "occurrence id out of range"),
    "position": (None, "outside the input's positions"),
    "order": (None, "out of position order"),
}


@pytest.mark.parametrize("what", sorted(FAULTS))
@pytest.mark.parametrize("id_bits", [32, 24])
def test_faults_raise_before_the_output_exists(tmp_path, what, id_bits):
    batches = _batches("mixed")
    keys = _keys(batches, "random", id_bits, 50)
    bad, msg = FAULTS[what]
    mask = np.uint64((1 << id_bits) - 1)
    if bad is not None:
        keys[3] = (keys[3] & ~mask) | np.uint64(bad + (1 << (id_bits - 1)))
    elif what == "position":  # past the last row's valid positions
        keys[-1] = (keys[-1] & mask) | (np.uint64(len(emit_cases.valid_flats(batches, P)) * P)
                                        << np.uint64(id_bits))
    else:
        keys[[3, 4]] = keys[[4, 3]]
    out = tmp_path / "o.dbg"
    with pytest.raises(RuntimeError, match=msg):
        _card_bytes(tmp_path, batches, keys, 50, id_bits, 1 << 24, name="o.dbg")
    assert not out.exists()


def test_a_key_in_a_pad_row_raises(tmp_path):
    # one row of B holds the sequence, the rest pad
    batches = emit_cases.batches([K + 5], K, P, B)
    keys = np.asarray([(P * 2) << 32 | (1 + (1 << 31))], np.uint64)
    with pytest.raises(RuntimeError, match="outside the input's positions"):
        _card_bytes(tmp_path, batches, keys, 5, 32, 8)


def _entries(rounds, tmp_path=None, ck=None, seqs=None, **cfg):
    """The entries a CPU sort-engine run hands the merge, its batches and
    its .dbg (cfg: more PipelineConfig fields)."""
    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=list(fetched), batches=batches)
        return orig(fetched, batches, *a, **kw)

    out = None if tmp_path is None else str(tmp_path / f"r{rounds}.dbg")
    sortpipe.merge_fetched = capture
    try:
        sortpipe.build_junctions_sorted(
            None, PipelineConfig(k=K, rounds=rounds, positions_per_row=P, rows_per_batch=B,
                                 **cfg),
            out, sequences=seqs or _seqs(), device="cpu", checkpoint_dir=ck)
    finally:
        sortpipe.merge_fetched = orig
    return got["fetched"], got["batches"], None if out is None else open(out, "rb").read()


def _seqs():
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 900).astype(np.uint8)
    out = [(0, base)]
    for i in range(1, 4):
        s = base.copy()
        s[rng.random(len(s)) < 0.03] = rng.integers(0, 4)
        out.append((i, s))
    return out


@pytest.fixture(scope="module")
def jax_dbg(tmp_path_factory):
    """The JAX package's .dbg of _seqs() (every round count writes it)."""
    out = str(tmp_path_factory.mktemp("jax") / "jax.dbg")
    jax_build(None, JaxConfig(k=K, filter_bits=20, positions_per_row=P, rows_per_batch=B),
              out_path=out, sequences=_seqs())
    return open(out, "rb").read()


def _merge(entries, batches, out, free=None, logs=None, ops=KERNELS):
    with trace.span("twopaco") as root:
        enum = sortpipe.merge_rounds_packed(
            entries, batches, PipelineConfig(k=K, positions_per_row=P, rows_per_batch=B), out,
            RunStats(), (logs if logs is not None else []).append, dev=torch.device("cpu"),
            free=free, ops=ops)
    (write,) = _named(root, "emit_write") if out is not None else (None,)
    return enum, write


def _named(root, name):
    return [s for s in trace.descendants(root) if s.name == name]


def _records(path):
    return len(junction_io.read_junctions(str(path))[0])


def _refuse(*_a, **_k):
    raise AssertionError("a refused path ran")


def _refuse_unpacked_emit(monkeypatch):
    """pipeline.emit_junctions and its writer raise: a packed merge writes
    through emit.write_keys only."""
    for mod, name in ((pipeline, "emit_junctions"), (pipeline, "_write_spliced"),
                      (sortpipe, "emit_junctions")):
        monkeypatch.setattr(mod, name, _refuse)


def test_merge_of_one_card_entry(tmp_path):
    """A keyed entry whose keys stay on their device (a one-round build's,
    on the CPU here) is checked and written there (card_records = its
    records), with the build's bytes."""
    fetched, batches, want = _entries(1, tmp_path)
    (table, keys, _none), = card = fetched
    assert isinstance(keys, OccKeys) and keys.keys.dtype == torch.int64
    out = str(tmp_path / "card.dbg")
    enum, write = _merge(card, batches, out)
    assert open(out, "rb").read() == want
    assert write.counters["card_records"] == enum.stats.occurrences >= len(keys) > 0
    assert set(write.counters) >= {"decode_wait_s", "assemble_s", "sink_s", "bytes"}
    # no output: the check alone
    assert _merge(card, batches, None)[0].vertices_count == len(table)


@pytest.mark.parametrize("chunk_occ", [1, 5, 64])
def test_card_emit_chunks_fit_the_free_memory(tmp_path, chunk_occ):
    """Little free device memory: smaller chunks (a log line), the same
    bytes, every record still built on the card."""
    card, batches, want = _entries(1, tmp_path)
    free = emit.table_bytes(batches) + 2 * 12 * chunk_occ
    assert emit.chunk_size(batches, free) == chunk_occ
    out, logs = str(tmp_path / "card.dbg"), []
    enum, write = _merge(card, batches, out, free=free, logs=logs)
    assert open(out, "rb").read() == want
    assert f"Emit in chunks of {chunk_occ} occurrences" in "\n".join(logs)
    assert write.counters["card_records"] == enum.stats.occurrences


def test_card_emit_refuses_what_it_cannot_take(tmp_path):
    """Too little free memory for the one entry's emit tables, and
    sequence ids that fall (3, 2, 1, 0), for one entry, N merged on the
    merge's device, N merged on the host or a whole CPU -r 1 build, raise
    before the output exists."""
    card, batches, _want = _entries(1)
    out = tmp_path / "x.dbg"
    with pytest.raises(RuntimeError, match="tables need"):
        _merge(card, batches, str(out), free=emit.table_bytes(batches) + 2 * 12 - 1)
    falling_seqs = [(3 - i, c) for i, c in _seqs()]
    falling = sortpipe.read_batches(None, falling_seqs,
                                    PipelineConfig(k=K, positions_per_row=P, rows_per_batch=B),
                                    RunStats())[1]
    with pytest.raises(ValueError, match="sequence ids in input order"):
        _merge(card, falling, str(out))
    # N entries merged on the device or on the host take the same emit
    for free in (None, 1):
        with pytest.raises(ValueError, match="sequence ids in input order"):
            _merge(_entries(3)[0], falling, str(out), free=free)
    with pytest.raises(ValueError, match="sequence ids in input order"):
        _entries(1, tmp_path, seqs=falling_seqs)
    assert not out.exists() and not (tmp_path / "r1.dbg").exists()


@pytest.mark.parametrize("rounds", [1, 3])
def test_host_paths_count_no_card_records(tmp_path, monkeypatch, jax_dbg, rounds):
    """On the CPU one round's entry keeps its keys where the occurrence
    sort left them, and three rounds merge on the merge's device: either
    way the keys take emit.write_keys (its plain versions here), which
    counts every record it writes, and never the unpacked emit; the JAX
    package's bytes."""
    _refuse_unpacked_emit(monkeypatch)
    with trace.span("twopaco") as root:
        _f, _b, got = _entries(rounds, tmp_path)
    (write,) = _named(root, "emit_write")
    records = _records(tmp_path / f"r{rounds}.dbg")
    assert write.counters["card_records"] == records > 0
    assert got == jax_dbg


@pytest.mark.parametrize("rounds", [2, 3, 4])
def test_merged_rounds_write_the_host_emits_bytes(tmp_path, monkeypatch, jax_dbg, rounds):
    """A build of N rounds merges its keyed entries on the merge's device
    (the CPU here) and writes the merged keys through emit.write_keys: the
    JAX package's bytes, card_records = the records written, no unpacked
    emit."""
    _refuse_unpacked_emit(monkeypatch)
    with trace.span("twopaco") as root:  # four rounds of these few rows need the slack
        fetched, _b, got = _entries(rounds, tmp_path, round_slack=2.0)
    assert len(fetched) == rounds and all(isinstance(e[1], OccKeys) for e in fetched)
    assert got == jax_dbg
    (write,) = _named(root, "emit_write")
    assert write.counters["card_records"] == _records(tmp_path / f"r{rounds}.dbg") > 0


MERGED_FAULTS = {  # where: the entry's keys (the merge's faults) or the merged keys (the check's)
    ("entry", "id 0"): "occurrence id 0",
    ("entry", "past"): "occurrence id out of range",
    ("merged", "id 0"): "occurrence id 0",
    ("merged", "past"): "occurrence id out of range",
    ("merged", "order"): "out of position order",
}


@pytest.mark.parametrize("where,what", sorted(MERGED_FAULTS))
def test_merged_key_faults_raise_before_the_output_exists(tmp_path, monkeypatch, where, what):
    fetched, batches, _want = _entries(3)
    mask = np.uint64(0xFFFFFFFF)
    if where == "entry":
        table, keys, _none = fetched[1]
        k = keys.keys.clone()
        ku = k.numpy().view(np.uint64)
        bad = 0 if what == "id 0" else len(table) + 1
        ku[0] = (ku[0] & ~mask) | np.uint64(bad + (1 << 31))
        fetched[1] = (table, OccKeys(k, 32), None)
    else:
        merge_on_device = sortpipe.merge_on_device

        def corrupt(*a, **kw):
            table, keys = merge_on_device(*a, **kw)
            k = keys.numpy().view(np.uint64).copy()
            i = len(k) // 2
            if what == "order":
                k[[i, i + 1]] = k[[i + 1, i]]
            else:
                bad = 0 if what == "id 0" else len(table) + 1
                k[i] = (k[i] & ~mask) | np.uint64(bad + (1 << 31))
            return table, torch.from_numpy(k.view(np.int64))

        monkeypatch.setattr(sortpipe, "merge_on_device", corrupt)
    out = tmp_path / "x.dbg"
    with pytest.raises(RuntimeError, match=MERGED_FAULTS[where, what]):
        _merge(fetched, batches, str(out))
    assert not out.exists()


@pytest.mark.parametrize("short", [0, 1])
def test_a_merge_whose_emit_tables_do_not_fit_takes_the_host_merge(tmp_path, monkeypatch,
                                                                    jax_dbg, short):
    """The device merge is taken only where `free` holds its buffers and
    the emit's tables: at exactly that figure N entries merge on the
    merge's device; a byte less, the host merge runs, with a log line
    naming the bytes. Either way emit.write_keys writes the merged keys
    (card_records = the records) and the unpacked emit never runs: the
    JAX package's bytes."""
    fetched, batches, _want = _entries(3, tmp_path)
    need = (merge.device_bytes(sum(len(e[0]) for e in fetched), PipelineConfig(k=K).w,
                               sum(len(e[1]) for e in fetched), len(fetched))
            + emit.table_bytes(batches) + 2 * 12)
    ops = dataclasses.replace(KERNELS, merge=_refuse) if short else KERNELS
    _refuse_unpacked_emit(monkeypatch)
    out, logs = str(tmp_path / "m.dbg"), []
    enum, write = _merge(fetched, batches, out, free=need - short, logs=logs, ops=ops)
    host = [s for s in logs if s.startswith("Merge on the host")]
    assert host == ([f"Merge on the host: the device merge and the card emit need "
                     f"{sortpipe._gib(need)}, {sortpipe._gib(need - 1)} is free"]
                    if short else [])
    assert open(out, "rb").read() == jax_dbg and len(jax_dbg) > 0
    assert write.counters["card_records"] == enum.stats.occurrences == _records(out)


# ChunkWriter.write_raw (the card emit's writer) with every other record
# left out ("half") or one record's position moved ("alter") from the
# from_call-th writer on, each under one harness run of a tiny cell on the
# CPU: the benchmark's four-round sort cell, or a one-round Bloom cell of a
# traffic file written into the temporary root (a 2^20-slot filter, where
# bloom-f34's would take 2 GiB); the harness refuses a process that holds
# jax, so the runs of a cell are one child process
WRITER_FAULTS = {"half_left_out": ("half", 0), "one_altered": ("alter", 0),
          "window_only": ("alter", 1)}
PLANT = r"""
import json, sys
from pathlib import Path

import numpy as np

from gpubench.tests import cells
from twopaco_tpu_torch.io import junctions

real_init, real_raw = junctions.ChunkWriter.__init__, junctions.ChunkWriter.write_raw


def run(kind, from_call, tmp, traffic):
    writers = [0]

    def init(self, path):
        real_init(self, path)
        self.faulty = writers[0] >= from_call
        writers[0] += 1

    def write_raw(self, data):
        if self.faulty:
            rec = np.array(data).view(np.int32).reshape(-1, 3).copy()
            if kind == "half":
                rec = rec[::2]
            else:
                rec[len(rec) // 2, 1] += 1
            data = rec.reshape(-1)
        return real_raw(self, data)

    junctions.ChunkWriter.__init__, junctions.ChunkWriter.write_raw = init, write_raw
    try:
        root, cell = cells.make_root(tmp, traffic=traffic["name"])
        if "argv" in traffic:
            (root / "gpubench" / "traffic" / f"{traffic['name']}.json").write_text(
                json.dumps(traffic))
        rc, result, err = cells.run_cpu(root, cell, seconds=0.5 if from_call else 0.3)
    finally:
        junctions.ChunkWriter.__init__, junctions.ChunkWriter.write_raw = real_init, real_raw
    return {"rc": rc, "result": result, "err": err[-4000:]}


faults, tmp, traffic = json.loads(sys.argv[1]), Path(sys.argv[2]), json.loads(sys.argv[3])
print(json.dumps({name: run(kind, from_call, tmp / name, traffic)
                  for name, (kind, from_call) in faults.items()}))
"""
BLOOM_TRAFFIC = {"name": "bloom-r1-f20", "argv": ["--tpu-engine", "bloom", "-r", "1", "-f", "20"],
                 "loop": "closed, one client", "why": "a test: the Bloom engine at a small filter"}


def _plant(tmp_path_factory, traffic):
    run = subprocess.run([sys.executable, "-c", PLANT, json.dumps(WRITER_FAULTS),
                          str(tmp_path_factory.mktemp("plant")), json.dumps(traffic)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    return _plant(tmp_path_factory, {"name": "sort-r4"})


@pytest.fixture(scope="module")
def planted_bloom(tmp_path_factory):
    return _plant(tmp_path_factory, BLOOM_TRAFFIC)


def _caught(got, fault):
    result = got["result"]
    assert got["rc"] == 0 and result["correct"] is False, got["err"]
    differing = result["compared"]
    if WRITER_FAULTS[fault][1]:
        assert differing["records_differing"]["value"] == 0
        assert differing["window_builds_differing"]["value"] >= 1 and result["failed"] >= 1
    else:
        assert differing["records_differing"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(WRITER_FAULTS))
def test_the_benchmark_catches_a_fault_in_the_card_emit(planted, fault):
    """The benchmark's tiny four-round cell on the CPU merges its rounds and
    writes them through the card emit's ChunkWriter.write_raw; a fault
    planted there comes out not correct: records differing where every
    build is faulty, window builds differing where only the builds after
    the checked one are."""
    _caught(planted[fault], fault)


@pytest.mark.parametrize("fault", sorted(WRITER_FAULTS))
def test_the_benchmark_catches_a_fault_in_the_bloom_card_emit(planted_bloom, fault):
    """A tiny one-round Bloom cell on the CPU writes pass 4's keys through
    the same ChunkWriter.write_raw; the same faults come out not correct."""
    _caught(planted_bloom[fault], fault)


def test_card_entry_faults_raise_in_the_merge(tmp_path):
    fetched, batches, _want = _entries(1)
    (table, keys, _none), = fetched
    for bad, msg in ((0, "id 0"), (len(table) + 1, "out of range")):
        k = keys.keys.clone()
        ku = k.numpy().view(np.uint64)
        ku[0] = (ku[0] & ~np.uint64(0xFFFFFFFF)) | np.uint64(bad + (1 << 31))
        card = [(table, OccKeys(k, 32), None)]
        with pytest.raises(RuntimeError, match=msg):
            _merge(card, batches, str(tmp_path / "x.dbg"))
        assert not (tmp_path / "x.dbg").exists()


def test_card_keys_fetch_and_decode():
    """OccKeys.host() is the keys as u64 on the host; decode() and
    raw_entry give each key's position and signed id."""
    fetched, _batches, _want = _entries(1)
    table, keys, _none = fetched[0]
    host = keys.host()
    assert len(keys) == len(host) > 0 and host.dtype == np.uint64
    assert np.array_equal(host.view(np.int64), keys.keys.numpy())
    want_pos = (host >> np.uint64(32)).astype(np.int64)
    want_ids = (host & np.uint64(0xFFFFFFFF)).astype(np.int64) - (1 << 31)
    pos, ids = keys.decode()
    assert np.array_equal(pos, want_pos) and np.array_equal(ids, want_ids)
    assert (np.diff(pos) > 0).all() and (ids != 0).all() and np.abs(ids).max() <= len(table)
    t, pos, ids = sortpipe.raw_entry(fetched[0])
    assert t is table and np.array_equal(pos, want_pos) and np.array_equal(ids, want_ids)


@pytest.mark.parametrize("rounds", [1, 3])
def test_no_checkpoint_decodes_nothing(monkeypatch, rounds):
    """With no checkpoint directory a sort-engine build decodes no key and
    makes no raw entry."""
    def refuse(*_a, **_k):
        raise AssertionError("decoded with no checkpoint")

    monkeypatch.setattr(OccKeys, "decode", refuse)
    monkeypatch.setattr(sortpipe, "raw_entry", refuse)
    with trace.span("twopaco") as root:
        _entries(rounds)
    assert not _named(root, "checkpoint")


@pytest.mark.parametrize("rounds", [1, 3])
def test_checkpoint_files_hold_the_decoded_rounds(tmp_path, monkeypatch, jax_dbg, rounds):
    """With a directory each round's file holds its table and its keys
    decoded (the raw form), and a resume writes the same .dbg (at -r 3
    round 0 is built again and the restored raw rounds take the host
    merge): emit.write_keys writes the keys (card_records = the records;
    never the unpacked emit), the JAX package's bytes."""
    ck = str(tmp_path / "ck")
    fetched, _batches, want = _entries(rounds, tmp_path, ck=ck)
    assert len(fetched) == rounds
    for r, entry in enumerate(fetched):
        z = np.load(os.path.join(ck, f"round_{r}.npz"))
        assert set(z.files) == {"stats", "table", "occ_pos", "occ_ids"}
        for name, a in zip(("table", "occ_pos", "occ_ids"), sortpipe.raw_entry(entry)):
            assert np.array_equal(z[name], a) and z[name].dtype == a.dtype, name
    os.remove(os.path.join(ck, "round_0.npz"))
    _refuse_unpacked_emit(monkeypatch)
    with trace.span("twopaco") as root:
        again, _b, got = _entries(rounds, tmp_path, ck=ck)
    assert got == want == jax_dbg
    assert [isinstance(e[1], OccKeys) for e in again] == [True] + [False] * (rounds - 1)
    (write,) = _named(root, "emit_write")
    assert write.counters["card_records"] == _records(tmp_path / f"r{rounds}.dbg") > 0
