"""Port round sort and judge against twopaco_tpu sortpipe.sort_records
and judge_compact_fused (CPU tensors: the plain versions). The port sorts
by the leading key_bits bits of the words (2k for genome records, whose
bits below the k-mer are zero; 32w for random words).

lax.sort is not stable, so the sort is held to equal keys and, per key,
equal multisets of (payload, position). The judges are then fed the same
sorted records, and both compact in record order: table, occurrences and
counts must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import judge, records, sort, sortpipe
from twopaco_tpu_torch.testing import judge_cases

B, P = 8, 128
NO_AB = judge.NO_ABUNDANCE


def _genome_records(k, seed, n_batches=2):
    """Records of a few related genomes, built by the JAX package."""
    rng = np.random.default_rng(seed)
    R = P + k + 1
    cfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    base = rng.integers(0, 4, size=3 * R).astype(np.uint8)
    cols = []
    for bi in range(n_batches):
        codes = np.stack([base[s : s + R] for s in rng.integers(0, 2 * R, size=B)])
        flip = rng.random(codes.shape) < 0.01
        codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
        codes[rng.random(codes.shape) < 0.005] = 4
        valid = np.full(B, P, np.int32)
        valid[-1] = P // 3
        packed, nmask = pack.pack_codes_host(codes)
        cols.append(jsort.build_sort_records(
            (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
            jsort._pos_base(bi * B, P, False), jnp.uint32(0),
            jnp.uint32(0xFFFFFFFF), cfg=cfg,
        ))
    words = np.concatenate([np.asarray(c[0]) for c in cols])
    pay = np.concatenate([np.asarray(c[1]) for c in cols])
    pos = np.concatenate([np.asarray(c[2][0]) for c in cols]).astype(np.int64)
    return words, pay, pos


def _random_records(w, m, seed):
    """Random keys with many duplicates, high-bit words and sentinels."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    dup = rng.random(m) < 0.7
    words[dup] = words[rng.integers(0, m // 16, size=int(dup.sum()))]
    sent = rng.random(m) < 0.15
    words[sent] = 0xFFFFFFFF
    ext = rng.integers(0, 5, size=(m, 2)).astype(np.uint32)
    pay = ext[:, 0] | (ext[:, 1] << 8) | (rng.integers(0, 2, m).astype(np.uint32) << 16)
    pay = np.where(sent, 0, pay | (1 << 17)).astype(np.uint32)
    pos = rng.permutation(m).astype(np.int64) * 3
    return words, pay, pos


# name -> (records, key_bits): genome records sort by their k-mer's 2k
# bits, random words by all 32w
CASES = {
    "genome_k25": (lambda: _genome_records(25, 1), 50),
    "genome_k101": (lambda: _genome_records(101, 2), 202),
    "random_w2": (lambda: _random_records(2, 2048, 3), 64),
    "random_w7": (lambda: _random_records(7, 2048, 4), 224),
}
# the k of the key_bits cut's cases: one word (9, 15), two (17, 25, 31),
# then a last word cut short (33, 101, 129, 603: w = 3, 7, 9, 38)
KEY_BITS_K = [9, 15, 17, 25, 31, 33, 101, 129, 603]


def _canon_rows(words, pay, pos):
    """Rows ordered by (words..., payload, pos): a per-key multiset view."""
    cols = [pos, pay] + [words[:, j] for j in reversed(range(words.shape[1]))]
    o = np.lexsort(cols)
    return words[o], pay[o], pos[o]


def _torch(words, pay, pos):
    return torch.from_numpy(words), torch.from_numpy(pay), torch.from_numpy(pos)


def _jax_sort(words, pay, pos):
    w = words.shape[1]
    jw, jp, jpos = jsort.sort_records(
        jnp.asarray(words), jnp.asarray(pay), (jnp.asarray(pos.astype(np.uint32)),), w=w
    )
    return np.asarray(jw), np.asarray(jp), np.asarray(jpos[0]).astype(np.int64)


def _same_order(got, want):
    """Equal keys in the same order (sentinels last) and, per key, equal
    multisets of (payload, pos)."""
    tw, tp, tpos = (t.numpy() for t in got)
    assert np.array_equal(tw, want[0])
    assert (tw[-1] == 0xFFFFFFFF).all()  # sentinels last
    for a, b in zip(_canon_rows(tw, tp, tpos), _canon_rows(*want)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_matches_jax(case):
    make, key_bits = CASES[case]
    words, pay, pos = make()
    _same_order(sort.sort_records(*_torch(words, pay, pos), key_bits=key_bits),
                _jax_sort(words, pay, pos))


@pytest.mark.parametrize("k", KEY_BITS_K)
def test_sort_key_bits_matches_jax(k):
    """Genome records sorted by their k-mer's 2k bits alone: JAX's
    full-word order (the bits below are zero in every real record), at
    every word count the engines meet, the last word cut short included."""
    words, pay, pos = _genome_records(k, k)
    assert words.shape[1] == -(-2 * k // 32)
    real = ((pay >> 17) & 1) == 1
    assert real.any() and (~real).any()
    _same_order(sort.sort_records(*_torch(words, pay, pos), key_bits=2 * k),
                _jax_sort(words, pay, pos))


@pytest.mark.parametrize("w,key_bits", [(1, 18), (2, 34), (2, 50), (3, 66), (7, 202)])
def test_sort_plain_ignores_the_bits_below_key_bits(w, key_bits):
    """Random bits below key_bits do not move a record: the order is the
    full-word order of the words with those bits cleared, stable."""
    words, pay, pos = _random_records(w, 4096, key_bits)
    sw, sp, spos = sort.sort_records_plain(*_torch(words, pay, pos), key_bits=key_bits)
    keep = np.array([(((1 << b) - 1) << (32 - b)) & 0xFFFFFFFF
                     for b in (min(32, max(0, key_bits - 32 * j)) for j in range(w))],
                    np.uint32)
    order = np.lexsort([np.arange(len(words))] + [(words & keep)[:, j]
                                                  for j in reversed(range(w))])
    assert np.array_equal(sw.numpy(), words[order])
    assert np.array_equal(spos.numpy(), pos[order])
    with pytest.raises(ValueError, match="key_bits"):
        sort.sort_records_plain(*_torch(words, pay, pos), key_bits=32 * w + 1)


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 40).map(lambda h: 2 * h + 1),
       chars=st.lists(st.sampled_from([0, 1, 2, 3]), min_size=1, max_size=80),
       t_run=st.integers(0, 81))
def test_no_canonical_kmer_is_all_ones(k, chars, t_run):
    """No canonical k-mer's top 2k bits are all ones, so a sentinel row
    (all-ones words) sorts after every real record under the key_bits cut:
    the record builder on rows that hold long runs of T (all ones as a
    forward k-mer), whose reverse complement A...A is smaller."""
    R = P + k + 1
    row = (chars * (R // len(chars) + 1))[:R]
    row[: min(t_run, R)] = [3] * min(t_run, R)
    packed, nmask = pack.pack_codes_host(np.array([row], np.uint8))
    words, pay, _pos = records.build_sort_records_plain(
        torch.from_numpy(packed), torch.from_numpy(nmask),
        torch.tensor([P], dtype=torch.int32), 0, k=k, P=P)
    words = pack.as_i64(words).numpy()
    real = (pack.as_i64(pay).numpy() >> 17) & 1 == 1
    assert real.all()
    bits = [min(32, max(0, 2 * k - 32 * j)) for j in range(words.shape[1])]
    top = np.array([(((1 << b) - 1) << (32 - b)) for b in bits], np.int64)
    assert not ((words & top) == top).all(axis=1).any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_matches_jax(case, abundance):
    make, key_bits = CASES[case]
    sw, sp, spos = sort.sort_records(*_torch(*make()), key_bits=key_bits)
    m, w = sw.shape
    got = judge.judge_compact(sw, sp, spos, abundance)
    tab, op, oi, ng, nj, no = jsort.judge_compact_fused(
        jnp.asarray(sw.numpy()), jnp.asarray(sp.numpy()),
        (jnp.asarray(spos.numpy().astype(np.uint32)),), jnp.uint64(abundance),
        check_abundance=abundance < NO_AB, chunk=m // 4,
    )
    nj, no = int(nj), int(no)
    assert got[3:] == (int(ng), nj, no)
    assert 0 < nj < int(ng)
    assert np.array_equal(got[0].numpy(), np.asarray(tab)[:nj])
    assert np.array_equal(got[1].numpy(), np.asarray(op[0])[:no].astype(np.int64))
    assert np.array_equal(got[2].numpy(), np.asarray(oi)[:no])


def test_judge_all_sentinels_and_empty():
    w = 2
    sent = torch.full((64, w), 0xFFFFFFFF, dtype=torch.int64)
    got = judge.judge_compact(
        pack.as_u32(sent), torch.zeros(64, dtype=torch.uint32),
        torch.arange(64),
    )
    assert got[3:] == (0, 0, 0) and got[0].shape == (0, w)
    empty = judge.judge_compact(
        torch.empty((0, w), dtype=torch.uint32),
        torch.empty(0, dtype=torch.uint32), torch.empty(0, dtype=torch.int64),
    )
    assert empty[3:] == (0, 0, 0)


# the judge kernel's edge inputs at CPU sizes: a group of 40,000 records
# (more than 0x7FFF N-in extensions) over many 2048-record tiles, groups
# on tile edges, a round that is mostly sentinels, a repeat-bearing round
EDGE = {
    "long_group": lambda rng: judge_cases.long_group(rng, rows=40_000),
    "tile_edges": judge_cases.tile_edges,
    "mostly_sentinels": judge_cases.CASES["mostly_sentinels"],
    "repeat_groups": judge_cases.repeat_groups,
}


@pytest.mark.parametrize("case", sorted(EDGE))
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_edge_cases_match_jax(case, abundance):
    """judge_compact_plain and judge_records_plain against the JAX judges
    on the kernel's edge inputs, with and without the abundance limit."""
    words, pay, pos = EDGE[case](np.random.default_rng(len(case)))
    m = len(words)
    sw, sp = (pack.as_u32(torch.from_numpy(a.astype(np.int64))) for a in (words, pay))
    check = abundance < NO_AB
    got = judge.judge_compact_plain(sw, sp, torch.from_numpy(pos), abundance)
    tab, op, oi, ng, nj, no = jsort.judge_compact_fused(
        jnp.asarray(words), jnp.asarray(pay), (jnp.asarray(pos.astype(np.uint32)),),
        jnp.uint64(abundance), check_abundance=check, chunk=m,
    )
    nj, no = int(nj), int(no)
    assert got[3:] == (int(ng), nj, no)
    assert np.array_equal(got[0].numpy(), np.asarray(tab)[:nj])
    assert np.array_equal(got[1].numpy(), np.asarray(op[0])[:no].astype(np.int64))
    assert np.array_equal(got[2].numpy(), np.asarray(oi)[:no])
    kf, keep, ids, ng2, nj2, no2 = jsort.judge_records(
        jnp.asarray(words), jnp.asarray(pay), jnp.uint64(abundance), check_abundance=check)
    rec = judge.judge_records_plain(sw, sp, abundance)
    assert rec[3:] == (int(ng2), int(nj2), int(no2)) == got[3:]
    for a, b in zip(rec[:3], (kf, keep, ids)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if case == "long_group":
        assert nj > 0 and (abundance == 3) == (no < 40_000)


@pytest.mark.parametrize("w", [1, 2, 7, 38])
def test_slot_bytes_is_the_sorts_term(w):
    """A round slot's bytes are the sort's term (the record twice and the
    sort's work), which covers the judge's need: the sorted record, its
    table and occurrence outputs and the kernel's scratch."""
    rec = 4 * w + 12
    sort_slot = (40 if w <= 2 else 24) + -(-256 * 8 // sort.SORT_TILE)
    assert sortpipe.slot_bytes(w) == 2 * rec + sort_slot
    assert sortpipe.slot_bytes(w) >= 2 * rec + 172 / 2048  # the judge's need
