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

    codes:   (B, P+k+1) uint8, S'[a-1 ...] per row, N-padded
    seq_id:  (B,) int32, global 0-based sequence index (-1 = pad row)
    pos0:    (B,) int64, padded coordinate p' of the row's first position
    valid:   (B,) int32, number of valid positions in the row
    n_pos:   (B,) int64, total vertex positions of the row's sequence
    row0:    global index of this batch's first row
    """

    codes: np.ndarray
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
