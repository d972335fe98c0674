"""Window batcher: fixed-shape (batch, positions) views of padded genomes.

The reference streams chunks with a k+1-char overlap and a sentinel 'N'
prepended/appended to every sequence (vertexenumerator.h:1108-1226,
common.h:39). Here the same coverage is produced as dense, fixed-shape
batches:

  padded sequence  S' = N + S + N          (codes, N = 4)
  vertex positions p' = 1 .. L-k+1         (k-mer S'[p'..p'+k))
  row r covers positions [a, a+P); its char slab is S'[a-1 : a-1+P+k+1]
  (P positions need P+k+1 chars: one prev char, P+k-1 window chars, one
  next char for the last position's out-edge).

Rows from different sequences share batches; short tails are padded with
N and masked via per-row valid counts. Sequences shorter than k produce
no rows at all (the reference skips them entirely, including stubs).

iter_window_batches cuts the uint8 rows on the host. The engines take
window_rows instead: the same batches' metadata with no codes, and a row
table into the run's codes staged in one buffer, from which the card packs
every row at once (passes/upload.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from twopaco_tpu_torch.dna import CODE_N


@dataclass(frozen=True)
class WindowConfig:
    k: int
    positions_per_row: int = 2048  # P
    rows_per_batch: int = 256  # B

    @property
    def row_chars(self) -> int:
        return self.positions_per_row + self.k + 1


@dataclass
class WindowBatch:
    """One fixed-shape batch of sequence windows.

    codes:   (B, P+k+1) uint8, S'[a-1 ...] per row, N-padded (None from
             window_rows: the rows are packed on the card)
    seq_id:  (B,) int32, global 0-based sequence index (-1 = pad row)
    pos0:    (B,) int64, padded coordinate p' of the row's first position
    valid:   (B,) int32, number of valid positions in the row
    n_pos:   (B,) int64, total vertex positions of the row's sequence
    row0:    global index of this batch's first row
    """

    codes: np.ndarray | None
    seq_id: np.ndarray
    pos0: np.ndarray
    valid: np.ndarray
    n_pos: np.ndarray
    row0: int


def iter_window_batches(
    sequences: Iterable[tuple[int, np.ndarray]],
    cfg: WindowConfig,
) -> Iterator[WindowBatch]:
    """sequences: iterable of (seq_id, codes uint8). Yields WindowBatch."""
    k, P, B = cfg.k, cfg.positions_per_row, cfg.rows_per_batch
    R = cfg.row_chars

    def fresh():
        return (
            np.full((B, R), CODE_N, dtype=np.uint8),
            np.full(B, -1, dtype=np.int32),
            np.zeros(B, dtype=np.int64),
            np.zeros(B, dtype=np.int32),
            np.zeros(B, dtype=np.int64),
        )

    codes_buf, seq_id_buf, pos0_buf, valid_buf, npos_buf = fresh()
    fill = 0
    row0 = 0
    for seq_id, codes in sequences:
        L = len(codes)
        if L < k:
            continue
        n_pos = L - k + 1
        padded = np.full(L + 2, CODE_N, dtype=np.uint8)
        padded[1 : L + 1] = codes
        for a in range(1, n_pos + 1, P):
            slab = padded[a - 1 : a - 1 + R]
            codes_buf[fill, : len(slab)] = slab
            seq_id_buf[fill] = seq_id
            pos0_buf[fill] = a
            valid_buf[fill] = min(P, n_pos + 1 - a)
            npos_buf[fill] = n_pos
            fill += 1
            if fill == B:
                yield WindowBatch(
                    codes_buf, seq_id_buf, pos0_buf, valid_buf, npos_buf,
                    row0,
                )
                row0 += B
                codes_buf, seq_id_buf, pos0_buf, valid_buf, npos_buf = fresh()
                fill = 0
    if fill:
        yield WindowBatch(
            codes_buf, seq_id_buf, pos0_buf, valid_buf, npos_buf, row0
        )


class WindowRows(list):
    """A run's window batches (WindowBatch, codes None) and what the card
    packs their rows from (passes/upload.py): the row table, (rows, 3)
    int64 a row: the staged-code index of its first char S'[a-1], and its
    sequence's codes [lo, hi) there (pad rows: 0, 0, 0); the row width R;
    and `codes`, the staged codes (every sequence's codes in input order,
    set by the caller)."""

    def __init__(self, batches, table: np.ndarray, row_chars: int):
        super().__init__(batches)
        self.table = table
        self.row_chars = row_chars
        self.codes = None


def window_rows(lengths, cfg: WindowConfig, seq_ids=None) -> WindowRows:
    """iter_window_batches' batches from the sequences' lengths alone.

    lengths: each sequence's char count, in input order, its codes staged
    right after the previous one's (sequence i starts at sum(lengths[:i]));
    seq_ids: their ids (default 0, 1, ...). Row j of a sequence starting
    at staged index s covers positions a = 1 + j*P ...: its char S'[a-1+i]
    is staged code s + a - 2 + i when that lies in [s, s + L), else N."""
    k, P, B = cfg.k, cfg.positions_per_row, cfg.rows_per_batch
    L = np.asarray(lengths, dtype=np.int64).reshape(-1)
    ids = np.arange(len(L)) if seq_ids is None else np.asarray(seq_ids).reshape(-1)
    start = np.cumsum(L) - L
    n_pos = L - k + 1
    per_seq = np.where(L >= k, -(-n_pos // P), 0)
    seq = np.repeat(np.arange(len(L)), per_seq)
    first = np.cumsum(per_seq) - per_seq
    a = 1 + (np.arange(len(seq)) - first[seq]) * P
    n_rows = -(-len(seq) // B) * B

    def col(vals, dtype, pad=0):
        out = np.full(n_rows, pad, dtype)
        out[: len(vals)] = vals
        return out

    seq_id = col(ids[seq], np.int32, -1)
    pos0 = col(a, np.int64)
    valid = col(np.minimum(P, n_pos[seq] + 1 - a), np.int32)
    npos = col(n_pos[seq], np.int64)
    table = np.zeros((n_rows, 3), np.int64)
    table[: len(seq)] = np.stack([start[seq] + a - 2, start[seq], start[seq] + L[seq]], axis=1)
    batches = [
        WindowBatch(None, seq_id[r : r + B], pos0[r : r + B], valid[r : r + B],
                    npos[r : r + B], r)
        for r in range(0, n_rows, B)
    ]
    return WindowRows(batches, table, cfg.row_chars)
