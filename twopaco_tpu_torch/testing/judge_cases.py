"""Edge inputs of the judge (passes/judge.py), made from a seed with numpy.

Each case is sorted records as the round sort leaves them: (words (m, w)
uint32, payload (m,) uint32, pos (m,) int64), groups of equal words in
increasing order, then the sentinel rows (all-ones words, payload 0).
Real rows carry random ACGT or N extensions and strands. The shapes aim
at the kernel's tiles of TILE records: a group over many tiles with more
than 0x7FFF N-in extensions (the saturating counts), groups on tile
edges, one record, a count off the tile, more than 2^24 records,
rounds that are all or mostly sentinels, and a repeat-bearing round (a
k-mer group of many tiles that starts and ends mid-tile, one that ends on
a tile boundary, both strands in every group).
"""

from __future__ import annotations

import numpy as np

TILE = 2048  # records a tile of kernels/csrc/judge.cu
REAL = 1 << 17


def payloads(rng, m: int, n_rate: float = 0.1) -> np.ndarray:
    """Real payloads: in | out << 8 | strand << 16 | REAL, each extension
    N (4) with probability n_rate, else a random ACGT."""
    ext = rng.integers(0, 4, size=(m, 2))
    ext[rng.random((m, 2)) < n_rate] = 4
    strand = rng.integers(0, 2, size=m)
    return (ext[:, 0] | (ext[:, 1] << 8) | (strand << 16) | REAL).astype(np.uint32)


def from_groups(rng, sizes, w: int, sentinels: int = 0, n_rate: float = 0.1):
    """Groups of the given sizes (distinct increasing words), then
    `sentinels` sentinel rows -> (words, payload, pos)."""
    sizes = np.asarray(sizes, np.int64)
    word0 = np.cumsum(rng.integers(1, 200, size=len(sizes), dtype=np.int64))
    assert not len(word0) or word0[-1] < 0xFFFFFFFF
    keys = rng.integers(0, 1 << 32, size=(len(sizes), w), dtype=np.uint64).astype(np.uint32)
    keys[:, 0] = word0
    words = np.repeat(keys, sizes, axis=0)
    pay = payloads(rng, len(words), n_rate)
    words = np.concatenate([words, np.full((sentinels, w), 0xFFFFFFFF, np.uint32)])
    pay = np.concatenate([pay, np.zeros(sentinels, np.uint32)])
    pos = rng.permutation(len(words)).astype(np.int64) * 3
    return words, pay, pos


def long_group(rng, rows: int = 150_000, w: int = 2):
    """Small groups around one real group of `rows` records (more than
    0x7FFF, over many tiles) whose every in-extension is N."""
    sizes = [3, 1, 5, 2] + [rows] + [2, 4, 1, 3]
    words, pay, pos = from_groups(rng, sizes, w, sentinels=17)
    lo = sum(sizes[:4])
    pay[lo : lo + rows] = (pay[lo : lo + rows] & ~np.uint32(0xFF)) | np.uint32(4)
    return words, pay, pos


def tile_edges(rng, w: int = 1):
    """Groups that fill whole tiles (from a tile's first record to its
    last), one over three tiles from a tile's start, and small ones."""
    sizes = [TILE, TILE, 7, TILE - 7, 3 * TILE, 1, 2, 3] + [1, 2] * 40
    return from_groups(rng, sizes, w, sentinels=TILE - 3)


def repeat_groups(rng, w: int = 2):
    """A round of k = 31 records (w = 2, the last word's 2 low bits zero)
    as interspersed repeats make it: small groups, then one group of 8
    tiles and more that starts and ends mid-tile, one that ends exactly on
    a tile boundary, groups of tens to thousands of records among small
    ones, then sentinels. Strands are random a record, so the groups of
    more than a few records hold both."""
    head = list(rng.integers(1, 5, size=200))
    if sum(head) % TILE == 0:
        head[0] += 1
    big = 8 * TILE + 777
    end = sum(head) + big
    to_edge = TILE - end % TILE  # the next group ends on a tile boundary
    mid = [int(x) for x in rng.integers(10, 3000, size=12)]
    tail = list(rng.integers(1, 5, size=600))
    sizes = head + [big, to_edge] + [x for pair in zip(mid, tail) for x in pair] + tail[12:]
    words, pay, pos = from_groups(rng, sizes, w, sentinels=1000, n_rate=0.05)
    real = pay != 0
    words[real, -1] &= np.uint32(0xFFFFFFFC)
    return words, pay, pos


def random_groups(rng, m: int, w: int, sent_frac: float = 0.1):
    """Groups of 1-4 records (most of them ~2.5) until m records, the
    last sent_frac of them sentinels."""
    real = m - int(m * sent_frac)
    sizes = rng.integers(1, 5, size=real // 2 + 2)
    sizes = sizes[: int(np.searchsorted(np.cumsum(sizes), real)) + 1]
    sizes[-1] -= int(sizes.sum()) - real
    sizes = sizes[sizes > 0]
    return from_groups(rng, sizes, w, sentinels=m - real)


CASES = {
    "long_group": lambda rng: long_group(rng),
    "tile_edges": lambda rng: tile_edges(rng),
    "one_record": lambda rng: from_groups(rng, [1], 2),
    "off_tile": lambda rng: random_groups(rng, 5 * TILE + 77, 2),
    "off_tile_w7": lambda rng: random_groups(rng, 3 * TILE + 5, 7),
    "over_2_24": lambda rng: random_groups(rng, (1 << 24) + 4099, 1, sent_frac=0.02),
    "all_sentinels": lambda rng: from_groups(rng, [], 2, sentinels=3 * TILE + 1),
    "mostly_sentinels": lambda rng: random_groups(rng, 4 * TILE + 9, 2, sent_frac=0.97),
    "repeat_groups": lambda rng: repeat_groups(rng),
}


def make(name: str, seed: int = 0):
    """The case `name` from `seed` -> (words, payload, pos) numpy."""
    return CASES[name](np.random.default_rng(seed))
