"""The yardstick's table of peaks and the byte counts of the kernels a
roofline share is reported for."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 80 GB (data sheet): HBM3 bandwidth, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12

_NOT_DEFINITE = np.ones(256, dtype=np.uint8)
for _ch in b"ACGTacgt":
    _NOT_DEFINITE[_ch] = 0


def key_words(k: int) -> int:
    """u32 words of a record's k-mer (2 bits a character)."""
    return -(-2 * k // 32)


def vertex_records(seqs, k: int) -> int:
    """The round sort's real records over all rounds: the positions of
    the input whose k characters are all definite (A, C, G, T), one
    record each. seqs: ASCII byte arrays, one a sequence."""
    total = 0
    for s in seqs:
        n = len(s) - k + 1
        if n <= 0:
            continue
        bad = np.concatenate([[0], np.cumsum(_NOT_DEFINITE[s], dtype=np.int64)])
        total += int(np.count_nonzero(bad[k:] == bad[:n]))
    return total


def sort_bytes(records: int, k: int) -> int:
    """The least bytes the round sort moves: each real record (its k-mer
    words, u32 payload and i64 position) read once and written once."""
    return records * 2 * (4 * key_words(k) + 12)


def merge_bytes(rows: int, keys: int, k: int) -> int:
    """The least bytes the device merge of the rounds' entries moves
    (kernels/csrc/merge.cu, the table of PERF.md's kernel row 18): each
    junction's table row (its k-mer words) and each junction occurrence's
    u64 key read once and written once. The row map between the two
    kernels is the merge's own scratch and is not counted."""
    return 2 * rows * 4 * key_words(k) + 2 * keys * 8
