"""Multi-round runs of the port against twopaco_tpu on the CPU (the plain
versions): the .dbg must be byte-identical to the JAX package's for -r
1..4 in every mode, for auto-rounds, through the merges and the emit at
every id width, and through the CLI.

The modes are picked by the JAX package's environment variables:
resident (the default), grouped (TWOPACO_RESIDENT_BYTES=1), stream
(TWOPACO_RESIDENT=0 and TWOPACO_GROUPED=0: TWOPACO_RESIDENT=0 alone goes
to grouped mode), histogram split (TWOPACO_UNIFORM_SPLIT=0) and the wide
merge layout (TWOPACO_POS64=1). Round intervals are internal: every
split gives the same bytes, so one JAX run is the reference for all.
"""

import numpy as np
import pytest

from twopaco_tpu import dna as jdna
from twopaco_tpu.cli.twopaco import main as jax_main
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes.pipeline import RunStats as JaxStats
from twopaco_tpu.passes import build_junctions
from twopaco_tpu.passes import pipeline as jpipe
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.cli.twopaco import main as port_main
from twopaco_tpu_torch.passes import histogram, partition, pipeline, sort, sortpipe, stream
from twopaco_tpu_torch.passes.pipeline import RunStats, config_from_jax

K, PR, BR = 11, 256, 4
MODES = {
    "resident": {},
    "grouped": {"TWOPACO_RESIDENT_BYTES": "1"},
    "stream": {"TWOPACO_RESIDENT": "0", "TWOPACO_GROUPED": "0"},
    "histogram": {"TWOPACO_UNIFORM_SPLIT": "0"},
    "pos64": {"TWOPACO_POS64": "1"},
}
# the mode's own step, which the run must reach
MODE_STEP = {
    "resident": (partition, "partition_batch_plain"),
    "grouped": (partition, "partition_batch_plain"),
    "stream": (stream, "compact_append_plain"),
    "histogram": (histogram, "histogram_vertex_hashes_plain"),
    "pos64": (partition, "partition_batch_plain"),
}


def _genomes(seed, length=2500, n=4):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(n - 1)]


SEQS = [(i, jdna.encode(s)) for i, s in enumerate(_genomes(123))]


def _jcfg(**kw):
    return JaxConfig(k=K, filter_bits=20, positions_per_row=PR, rows_per_batch=BR, **kw)


@pytest.fixture(scope="module")
def jax_dbg(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "jax.dbg")
    build_junctions(None, _jcfg(), out_path=out, sequences=SEQS)
    return open(out, "rb").read()


def _port(tmp_path, name="port.dbg", **kw):
    out = str(tmp_path / name)
    enum = sortpipe.build_junctions_sorted(
        None, config_from_jax(_jcfg(**kw)), out, sequences=SEQS, device="cpu"
    )
    return open(out, "rb").read(), enum


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _clear_modes(monkeypatch):
    for env in MODES.values():
        for name in env:
            monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
def test_rounds_byte_identical(tmp_path, monkeypatch, jax_dbg, mode, rounds):
    _clear_modes(monkeypatch)
    for name, val in MODES[mode].items():
        monkeypatch.setenv(name, val)
    calls = _spy(monkeypatch, *MODE_STEP[mode])
    got, enum = _port(tmp_path, rounds=rounds)
    assert got == jax_dbg and len(got) > 0
    assert len(enum.stats.rounds) == rounds
    assert bool(calls) == (rounds > 1)  # the mode's step ran
    assert {r["marks"] for r in enum.stats.rounds} != {0}


@pytest.mark.parametrize("mode", ["resident", "stream"])
def test_auto_rounds_small_sort_chunk(tmp_path, monkeypatch, jax_dbg, mode):
    """-r 1 with a sort cap far below the input: the rounds come from the
    cap (4 resident rounds, 6 stream rounds here)."""
    _clear_modes(monkeypatch)
    for name, val in MODES[mode].items():
        monkeypatch.setenv(name, val)
    got, enum = _port(tmp_path, sort_chunk=1024)
    assert got == jax_dbg
    assert len(enum.stats.rounds) == {"resident": 4, "stream": 6}[mode]


def test_jax_multi_round_agrees(tmp_path, jax_dbg):
    """The JAX package's own -r 3 (resident) gives the same bytes, so the
    single reference above stands for every split."""
    out = str(tmp_path / "j3.dbg")
    build_junctions(None, _jcfg(rounds=3), out_path=out, sequences=SEQS)
    assert open(out, "rb").read() == jax_dbg


@pytest.mark.parametrize("mode", ["resident", "grouped", "stream"])
def test_overflow_raises(tmp_path, monkeypatch, mode):
    """A round buffer or block too small for its records raises, as the
    JAX package does (test_sort_rounds.py test_overflow_detection)."""
    _clear_modes(monkeypatch)
    for name, val in MODES[mode].items():
        monkeypatch.setenv(name, val)
    rng = np.random.default_rng(7)
    seqs = [(0, jdna.encode(oracle.generate_sequence(rng, 2000)))]
    cfg = config_from_jax(JaxConfig(
        k=9, positions_per_row=8, rows_per_batch=1, sort_chunk=16, round_slack=0.1,
    ))
    with pytest.raises(RuntimeError, match="overflow"):
        sortpipe.build_junctions_sorted(
            None, cfg, str(tmp_path / "x.dbg"), sequences=seqs, device="cpu"
        )


@pytest.fixture(scope="module")
def fetched_rounds():
    """The port's fetched rounds of a -r 3 run as raw entries (the run
    hands the merge sorted keys, tests/test_torch_occ.py), and its
    batches."""
    got = {}

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=fetched, batches=batches)

    orig = sortpipe.merge_fetched
    sortpipe.merge_fetched = capture
    try:
        sortpipe.build_junctions_sorted(
            None, config_from_jax(_jcfg(rounds=3)), None, sequences=SEQS, device="cpu"
        )
    finally:
        sortpipe.merge_fetched = orig
    assert len(got["fetched"]) == 3
    return [sortpipe.raw_entry(e) for e in got["fetched"]], got["batches"]


def _jax_fetched(fetched):
    return [(t, "raw", ((p,), i)) for t, p, i in fetched]


@pytest.mark.parametrize("pos_bits", [32, 40])
def test_merge_packed_matches_jax(tmp_path, fetched_rounds, jax_dbg, pos_bits):
    fetched, batches = fetched_rounds
    jcfg = _jcfg()
    tout, jout = str(tmp_path / "t.dbg"), str(tmp_path / "j.dbg")
    sortpipe.merge_rounds_packed(
        fetched, batches, config_from_jax(jcfg), tout, RunStats(), print, 0.0,
        pos_bits=pos_bits,
    )
    jsort.merge_rounds_packed(
        _jax_fetched(fetched), batches, jcfg.pass_config(filterless=True), jcfg,
        jout, JaxStats(), print, 0.0, pos_bits=pos_bits,
    )
    assert open(tout, "rb").read() == open(jout, "rb").read() == jax_dbg


def test_merge_unpacked_matches_jax(tmp_path, fetched_rounds, jax_dbg):
    fetched, batches = fetched_rounds
    jcfg = _jcfg()
    tout, jout = str(tmp_path / "t.dbg"), str(tmp_path / "j.dbg")
    tables = [t for t, _, _ in fetched]
    occ = [(p, i) for _, p, i in fetched]
    sortpipe.merge_rounds_and_emit(
        tables, occ, batches, config_from_jax(jcfg), tout, RunStats(), print, 0.0,
    )
    jsort.merge_rounds_and_emit(
        tables, occ, batches, jcfg.pass_config(filterless=True), jcfg, jout,
        JaxStats(), print, 0.0,
    )
    assert open(tout, "rb").read() == open(jout, "rb").read() == jax_dbg


def test_merge_rejects_corrupt_rounds(fetched_rounds):
    fetched, batches = fetched_rounds
    cfg = config_from_jax(_jcfg())
    (t0, p0, i0), rest = fetched[0], fetched[1:]
    bad_ids = {
        "out of range": i0.copy(),
        "id 0": i0.copy(),
    }
    bad_ids["out of range"][0] = len(t0) + 1
    bad_ids["id 0"][0] = 0
    for msg, ids in bad_ids.items():
        with pytest.raises(RuntimeError, match=msg):
            sortpipe.merge_rounds_packed(
                [(t0, p0, ids)] + rest, batches, cfg, None, RunStats(), print, 0.0,
            )
    with pytest.raises(AssertionError, match="duplicate"):
        sortpipe.merge_rounds_packed(
            [(t0, p0, i0), (t0, p0, i0)], batches, cfg, None, RunStats(), print, 0.0,
        )


@pytest.mark.parametrize("id_bits", [20, 31, 32, 40])
def test_emit_id_bits_matches_jax(tmp_path, fetched_rounds, jax_dbg, id_bits):
    """emit_junctions_packed at every key split, and the unpacked
    emit_junctions, against the JAX package's on the same occurrences."""
    fetched, batches = fetched_rounds
    got = {}

    def capture(table, occ_pos, occ_ids, *a, **kw):
        got.update(n=len(table), pos=occ_pos, ids=occ_ids)

    orig = sortpipe.finish_emit
    sortpipe.finish_emit = capture
    try:
        sortpipe.merge_rounds_and_emit(
            [t for t, _, _ in fetched], [(p, i) for _, p, i in fetched], batches,
            config_from_jax(_jcfg()), None, RunStats(), print, 0.0,
        )
    finally:
        sortpipe.finish_emit = orig
    bias = 1 << (id_bits - 1)
    keys = (got["pos"].astype(np.uint64) << np.uint64(id_bits)) | (
        got["ids"] + bias
    ).astype(np.uint64)
    outs = {}
    for name, fn in (("port", pipeline.emit_junctions_packed),
                     ("jax", jpipe.emit_junctions_packed)):
        outs[name] = str(tmp_path / f"{name}.dbg")
        fn(outs[name], batches, keys, got["n"], PR, id_bits=id_bits)
    unpacked = str(tmp_path / "unpacked.dbg")
    pipeline.emit_junctions(unpacked, batches, got["pos"], got["ids"], got["n"], PR)
    for path in (*outs.values(), unpacked):
        assert open(path, "rb").read() == jax_dbg


def _fasta(tmp_path):
    path = tmp_path / "g.fa"
    with open(path, "w") as f:
        for i, s in enumerate(_genomes(9, length=1200, n=3)):
            f.write(f">s{i} genome {i}\n{s[:600]}\n{s[600:]}\n")
    return str(path)


def test_cli_three_rounds_byte_identical(tmp_path, capsys):
    fa = _fasta(tmp_path)
    tout, jout = str(tmp_path / "port.dbg"), str(tmp_path / "jax.dbg")
    assert port_main(["-k", "25", "-f", "20", "-r", "3", "--device", "cpu", fa, "-o", tout]) == 0
    text = capsys.readouterr().out
    assert jax_main(["-k", "25", "-f", "20", "-r", "3", fa, "-o", jout]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()
    keys = {line.split("\t")[1] for line in text.splitlines() if line.startswith("time\t")}
    assert set(sortpipe.PHASES) <= keys  # one reader fits every mode


def test_plan_rounds_from_device_memory(monkeypatch):
    """sort_chunk None: one round when the input fits the free memory,
    else rounds of at most half of it; too little memory raises, naming
    the memory the input needs."""
    monkeypatch.delenv("TWOPACO_RESIDENT_BYTES", raising=False)
    cfg = pipeline.PipelineConfig(k=25, rounds=2, positions_per_row=2048, rows_per_batch=256)
    bp, sb = 2048 * 256, sortpipe.slot_bytes(cfg.w)
    n_slots = 123 * bp
    assert sortpipe.plan_rounds(cfg, n_slots, bp, None) == (2, n_slots + bp)
    assert sortpipe.plan_rounds(cfg, n_slots, bp, n_slots * sb)[0] == 2
    free = n_slots * sb // 3  # a third of what one round would need
    n_rounds, round_buf = sortpipe.plan_rounds(cfg, n_slots, bp, free)
    # half the memory for the records, with the slack: at most 5/8 of it
    assert n_rounds >= 6 and round_buf * sb <= free * 5 // 8 + 2 * bp * sb
    with pytest.raises(RuntimeError, match="GiB"):
        sortpipe.plan_rounds(cfg, n_slots, bp, 3 * bp * sb)
    # the judge's u32 scans: no round reaches 2^31 slots
    n_big = 5000 * bp
    n_rounds, round_buf = sortpipe.plan_rounds(cfg, n_big, bp, None)
    assert round_buf < 1 << 31 and n_rounds * round_buf >= n_big


@pytest.mark.parametrize("k", [9, 25, 31, 33, 101, 129, 603])
def test_slot_bytes_counts_the_sort_work(k):
    """A round's slots at slot_bytes each hold the records before and after
    the sort and everything sort.py allocates for it: two key buffers, two
    of the payloads and positions (w <= 2) or of the permutation, and the
    look-back status array and histograms of its passes (at most 4w), for
    any round from one batch of the smallest CLI tier up to 2^31 slots."""
    w = pipeline.PipelineConfig(k=k).w
    rec = 4 * w + 12
    passes = sort.n_passes(w, 2 * k)
    assert passes == -(-2 * k // 8) if w <= 2 else passes <= 4 * w
    for n in (2048 * 256, 123 * 2048 * 256, (1 << 31) - 1):
        assert sort.scratch_bytes(n, passes) <= sort.scratch_bytes(n, 4 * w)
        assert sort.scratch_bytes(n, 4 * w) >= n * 2 // 3  # 256 u64 a 3072-record tile
        assert n * sortpipe.slot_bytes(w) >= 2 * rec * n + sort.work_bytes(n, w)


def test_resident_budget(monkeypatch):
    cfg = pipeline.PipelineConfig(k=25, positions_per_row=2048, rows_per_batch=256)
    bp, n_slots = 2048 * 256, 123 * 2048 * 256
    monkeypatch.delenv("TWOPACO_RESIDENT_BYTES", raising=False)
    assert sortpipe.resident_budget(cfg, n_slots, bp, 4, None) == 6 << 30
    round_slots = -(-int(n_slots * 1.25) // 4) + bp
    free = 70 << 30
    assert sortpipe.resident_budget(cfg, n_slots, bp, 4, free) == (
        free - round_slots * sortpipe.slot_bytes(cfg.w)
    )
    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "12345")
    assert sortpipe.resident_budget(cfg, n_slots, bp, 4, free) == 12345
