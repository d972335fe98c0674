"""The occurrence sort (passes/occ.py) against twopaco_tpu's 4-byte
packed occurrences (sortpipe._pack_occ -> _unpack_occ, the cases of
tests/test_pack_occ.py), and the sort engine's merge with sorted-key
entries: its .dbg must stay the JAX package's at -r 1 and -r 3, after a
resume, with mixed raw and sorted entries and through the unpacked merge."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.passes import occ, sortpipe
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.pipeline import RunStats, config_from_jax


def _jax_unpacked(pos, oi, delta_bits, wide):
    """JAX _pack_occ -> _unpack_occ of the occurrences (any order) ->
    (positions, signed local ids), position-sorted."""
    n = len(pos)
    cap = 1 << max(n - 1, 1).bit_length()
    pad = np.zeros(cap - n, np.uint32)
    if wide:
        pos_d = (jnp.asarray(np.concatenate([(pos >> 32).astype(np.uint32), pad])),
                 jnp.asarray(np.concatenate([(pos & 0xFFFFFFFF).astype(np.uint32), pad])))
    else:
        pos_d = (jnp.asarray(np.concatenate([pos.astype(np.uint32), pad])),)
    oi_d = jnp.asarray(np.concatenate([oi, np.zeros(cap - n, np.int32)]))
    packed, exc_i, exc_hi, exc_lo, _n_exc = jsort._pack_occ(
        pos_d, oi_d, jnp.uint32(n), exc_cap=1024, delta_bits=delta_bits)
    got_pos, sign, lid = jsort._unpack_occ(
        np.asarray(packed)[:n], np.asarray(exc_i), np.asarray(exc_hi), np.asarray(exc_lo),
        delta_bits)
    return got_pos, np.where(sign, -lid.astype(np.int64), lid.astype(np.int64))


def _port_sorted(pos, oi, id_bits, pos_limit):
    keys, bad = occ.sort_occurrences(torch.from_numpy(pos.astype(np.int64)),
                                     torch.from_numpy(oi.astype(np.int32)),
                                     id_bits=id_bits, pos_limit=pos_limit)
    assert int(bad) == 0
    return OccKeys(keys.numpy().view(np.uint64), id_bits).decode()


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("delta_bits", [11, 14])
def test_sort_occurrences_matches_pack_occ(wide, delta_bits):
    """Shuffled (k-mer order) occurrences with small gaps and huge jumps
    come back position-sorted with their ids, as _pack_occ's round trip
    gives them; narrow (32/32 keys) and wide (33/31)."""
    rng = np.random.default_rng(delta_bits + wide)
    n = 5000
    deltas = rng.integers(1, 200, size=n).astype(np.uint64)
    big = rng.random(n) < 0.01
    deltas[big] += rng.integers(1 << delta_bits, 1 << 22, size=int(big.sum()), dtype=np.uint64)
    base = np.uint64(5 << 30) if wide else np.uint64(0)
    pos = (np.cumsum(deltas) + base).astype(np.int64)
    lid_bits = 31 - delta_bits
    lid = rng.integers(1, 1 << lid_bits, size=n).astype(np.int32)
    oi = np.where(rng.random(n) < 0.5, -lid, lid).astype(np.int32)
    perm = rng.permutation(n)
    want_pos, want_ids = _jax_unpacked(pos[perm].astype(np.uint64), oi[perm], delta_bits, wide)
    pos_bits = 33 if wide else 32
    got_pos, got_ids = _port_sorted(pos[perm], oi[perm], 64 - pos_bits, 1 << pos_bits)
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert int(got_pos[-1]) > (1 << 32) - 1 or not wide


def test_sort_occurrences_first_record_exception():
    """tests/test_pack_occ.py:75: a first position beyond 2^delta_bits."""
    pos = np.array([(1 << 20) + 3, 1 << 20], np.int64)
    oi = np.array([-7, 5], np.int32)
    want_pos, want_ids = _jax_unpacked(pos.astype(np.uint64), oi, 14, False)
    got_pos, got_ids = _port_sorted(pos, oi, 32, 1 << 32)
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_ids, [5, -7])


def test_sort_occurrences_flags_bad_occurrences():
    """Positions outside [0, pos_limit), id 0 and ids past id_bits - 1 bits
    are counted; an entry with any raises at fetch."""
    pos = torch.tensor([5, 100, -1, 7, 8], dtype=torch.int64)
    ids = torch.tensor([1, 2, 3, 0, 1 << 20], dtype=torch.int32)
    _keys, bad = occ.sort_occurrences(pos, ids, id_bits=20, pos_limit=100)
    assert int(bad) == 4  # 100 >= limit, -1, id 0, |id| = 2^19 * 2
    table = torch.zeros((3, 1), dtype=torch.uint32)
    with pytest.raises(RuntimeError, match="outside the merge key"):
        sortpipe.fetch_entry(table, occ.sort_occurrences(pos, ids, id_bits=20, pos_limit=100),
                             20)
    with pytest.raises(ValueError, match="do not fit"):
        occ.sort_occurrences(pos, ids, id_bits=40, pos_limit=1 << 30)


def _genomes(seed, length=2500, n=4):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [(i, jdna.encode(s)) for i, s in enumerate(
        [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(n - 1)])]


def _jcfg(**kw):
    return JaxConfig(k=11, filter_bits=20, positions_per_row=256, rows_per_batch=4, **kw)


@pytest.fixture(scope="module")
def jax_dbg(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "jax.dbg")
    build_junctions(None, _jcfg(), out_path=out, sequences=_genomes(123))
    return open(out, "rb").read()


def _capture(monkeypatch):
    got = []
    orig = sortpipe.merge_fetched

    def capture(fetched, *a, **kw):
        got.append(list(fetched))
        return orig(fetched, *a, **kw)

    monkeypatch.setattr(sortpipe, "merge_fetched", capture)
    return got


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("pos64", [False, True])
def test_sort_engine_sorted_key_entries(tmp_path, monkeypatch, jax_dbg, rounds, pos64):
    """Every round of the sort engine reaches the merge as sorted keys, and
    the .dbg is the JAX package's."""
    monkeypatch.delenv("TWOPACO_RESIDENT", raising=False)
    if pos64:
        monkeypatch.setenv("TWOPACO_POS64", "1")
    got = _capture(monkeypatch)
    out = str(tmp_path / "o.dbg")
    sortpipe.build_junctions_sorted(None, config_from_jax(_jcfg(rounds=rounds)), out,
                                    sequences=_genomes(123), device="cpu")
    assert open(out, "rb").read() == jax_dbg
    (fetched,) = got
    assert len(fetched) == rounds
    for table, keys, none in fetched:
        assert isinstance(keys, OccKeys) and none is None
        assert keys.id_bits == (31 if pos64 else 32)
        assert (np.diff(keys.keys.astype(np.float64)) > 0).all()


def test_sort_engine_resume_from_raw_checkpoints(tmp_path, monkeypatch, jax_dbg):
    """Rounds are checkpointed raw (sorted keys are decoded on save); a
    resume mixes restored raw entries with a recomputed sorted-key one."""
    got = _capture(monkeypatch)
    cfg = config_from_jax(_jcfg(rounds=3))
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "o.dbg")
    sortpipe.build_junctions_sorted(None, cfg, out, sequences=_genomes(123), device="cpu",
                                    checkpoint_dir=ck)
    z = np.load(str(tmp_path / "ck" / "round_0.npz"))
    assert set(z.files) == {"stats", "table", "occ_pos", "occ_ids"}
    os.remove(str(tmp_path / "ck" / "round_1.npz"))
    sortpipe.build_junctions_sorted(None, cfg, out, sequences=_genomes(123), device="cpu",
                                    checkpoint_dir=ck)
    assert open(out, "rb").read() == jax_dbg
    kinds = [isinstance(e[1], OccKeys) for e in got[-1]]
    assert kinds == [False, True, False]


def _key_entries():
    """The sorted-key entries of a -r 3 run, and its batches."""
    got = {}

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=fetched, batches=batches)

    orig = sortpipe.merge_fetched
    sortpipe.merge_fetched = capture
    try:
        sortpipe.build_junctions_sorted(None, config_from_jax(_jcfg(rounds=3)), None,
                                        sequences=_genomes(123), device="cpu")
    finally:
        sortpipe.merge_fetched = orig
    return got["fetched"], got["batches"]


def test_merge_mixed_and_unpacked(tmp_path, jax_dbg):
    """Raw and sorted-key entries merge to the same bytes; so does the
    unpacked merge, which decodes the keys (forced by a sequence count
    past the packed ids)."""
    fetched, batches = _key_entries()
    cfg = config_from_jax(_jcfg())
    mixed = [sortpipe.raw_entry(fetched[0]), fetched[1], sortpipe.raw_entry(fetched[2])]
    for name, entries, n_seq in (("keys", fetched, 4), ("mixed", mixed, 4),
                                 ("unpacked", fetched, 1 << 31)):
        out = str(tmp_path / f"{name}.dbg")
        sortpipe.merge_fetched(entries, batches, cfg, out, RunStats(), print, 0.0,
                               n_slots=3 * 4 * 256, wide=False, n_sequences=n_seq)
        assert open(out, "rb").read() == jax_dbg, name


def test_merge_rejects_corrupt_key_entries():
    fetched, batches = _key_entries()
    cfg = config_from_jax(_jcfg())
    table, keys, _ = fetched[0]
    for bad_id, msg in ((0, "id 0"), (len(table) + 1, "out of range")):
        k = keys.keys.copy()
        k[0] = (k[0] & ~np.uint64(0xFFFFFFFF)) | np.uint64(bad_id + (1 << 31))
        with pytest.raises(RuntimeError, match=msg):
            sortpipe.merge_rounds_packed([(table, OccKeys(k, 32), None)] + fetched[1:], batches,
                                         cfg, None, RunStats(), print, 0.0)
    with pytest.raises(ValueError, match="id bits"):
        sortpipe.merge_rounds_packed(fetched, batches, cfg, None, RunStats(), print, 0.0,
                                     pos_bits=40)


@pytest.mark.parametrize("kind", ["stable", "quicksort"])
def test_occurrence_sort_kinds_agree(kind):
    """packed_occurrences + either np.sort kind: the same sorted keys (the
    two kinds are timed on the card's host, PERF.md)."""
    fetched, _batches = _key_entries()
    _table, inv = sortpipe.merge_tables(fetched, 1)
    buf = sortpipe.packed_occurrences(fetched, inv, 32)
    want = np.sort(buf)
    buf.sort(kind=kind)
    np.testing.assert_array_equal(buf, want)
    assert len(buf) > 0
