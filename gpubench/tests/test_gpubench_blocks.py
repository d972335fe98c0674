"""The plain reference in blocks by canonical k-mer range against the
reference in one block: the same .dbg bytes and the same junction and
occurrence counts for B = 2, 3 and 7, at k = 31 and 25, on a seeded input
with runs of N, sequences shorter than k, stubs that are junctions and
stubs that are not, and repeat copies on both strands. Small chunks make
each block's walk and the ordering cross many pieces."""

import numpy as np
import pytest

from gpubench import genome, reference
from gpubench.tests import cells

SEED = 2**31 + 61
_RECORD = np.dtype([("pos", "<u4"), ("id", "<i8")])


def _input(k):
    """The codes of: three repeat-bearing genomes with N runs; a copy of a
    stretch of the first (its first and last k-mers recur with other
    neighbours: stubs that are junctions); a random sequence of its own
    (its ends are no junctions: stubs); a sequence of k - 1 characters and
    one of exactly k; an empty one."""
    rng = np.random.default_rng(SEED)
    seqs = genome.make_bench_genomes(3, 20_000, 0.01, 1e-3, seed=SEED,
                                     repeats=cells.TINY_REPEATS["repeats"])
    for s in seqs:
        for a in rng.integers(0, len(s) - 40, size=5):
            s[a : a + rng.integers(1, 40)] = ord("N")
    alone, short = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(2, 3000))]
    seqs += [seqs[0][5000:9000].copy(), alone, short[: k - 1].copy(), short[:k].copy(),
             short[:0].copy()]
    return [reference._LUT[s] for s in seqs]


@pytest.fixture(scope="module", params=[31, 25])
def one_block(request):
    k = request.param
    codes = _input(k)
    rows, n_junc = reference.junction_records(codes, k, blocks=1)
    dbg = rows.numpy().view(np.uint8).reshape(-1)
    return k, codes, dbg, n_junc


def test_the_input_has_what_the_blocks_must_keep(one_block):
    k, codes, dbg, n_junc = one_block
    rec = np.frombuffer(dbg, dtype=_RECORD)
    sep = rec["id"] == np.iinfo(np.int64).max
    seq = np.cumsum(sep)[~sep]  # each record's sequence
    pos, ids = rec["pos"][~sep], rec["id"][~sep]
    occ = ids[np.abs(ids) <= n_junc]
    assert len(np.intersect1d(occ[occ > 0], -occ[occ < 0])) >= 10  # read on both strands
    assert reference.occurrences(dbg, n_junc)[1] >= 5  # repeat copies
    assert any((c == 4).sum() >= 10 for c in codes)  # N runs
    first = {int(s): int(i) for s, p, i in zip(seq, pos, ids) if p == 0}
    assert abs(first[3]) <= n_junc  # the copy's first vertex: a stub that is a junction
    assert first[4] > n_junc  # the random sequence's: a stub that is none
    assert 5 not in seq and 6 in seq and 7 not in seq  # shorter than k, exactly k, empty


@pytest.mark.parametrize("blocks", [1, 2, 3, 7])
def test_blocks_give_the_one_block_bytes(one_block, monkeypatch, blocks):
    k, codes, want, n_junc = one_block
    monkeypatch.setattr(reference, "CHUNK", 4099)
    rows, got_junc = reference.junction_records(codes, k, blocks=blocks)
    got = rows.numpy().view(np.uint8).reshape(-1)
    assert got_junc == n_junc
    assert reference.occurrences(got, got_junc) == reference.occurrences(want, n_junc)
    assert bytes(got) == bytes(want)


def test_key_bounds_and_plan():
    assert reference.key_bounds(31, 1) == [0, 4**31]
    b = reference.key_bounds(25, 7)
    assert b[0] == 0 and b[-1] == 4**25 and b == sorted(b) and len(set(b)) == 8
    # a random sequence's canonical k-mers fall about evenly into the blocks
    codes = np.random.default_rng(3).integers(0, 4, size=200_000).astype(np.uint8)
    import torch

    canon = reference.vertices(torch.from_numpy(codes).to(torch.int64), 25)[1].numpy()
    counts = np.histogram(canon, bins=np.array(b, dtype=np.float64))[0]
    assert counts.min() > 0.9 * len(canon) / 7 and counts.max() < 1.1 * len(canon) / 7
    assert reference.plan_blocks(10**9, None) == 1
    room = 80 * 10**9 - reference.CHUNK * reference.CHUNK_BYTES_A_POSITION
    assert reference.plan_blocks(room // reference.BLOCK_BYTES_A_VERTEX, 80 * 10**9) == 1
    assert reference.plan_blocks(3 * room // reference.BLOCK_BYTES_A_VERTEX + 1,
                                 80 * 10**9) == 4
    with pytest.raises(RuntimeError, match="one chunk"):
        reference.plan_blocks(10, 1 << 20)
