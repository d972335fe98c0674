"""Inputs of the card emit (passes/emit.py), made from a seed with numpy:
window batches of sequences of chosen lengths, and position-sorted u64
occurrence keys over their valid positions (passes/occ.py's layout).

The lengths aim at the emit's places: a one-position sequence (length k),
a sequence shorter than k (no rows: a chromosome skipped, two separators
at once), rows across batches and pad rows, many sequences, and runs of
stubs and separators longer than a kernel block stages (kernels/csrc/
emit.cu, EMIT_CAP).
"""

from __future__ import annotations

import numpy as np

from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats


def lengths(kind: str, k: int) -> list[int]:
    """Sequence lengths of a case: "mixed", "many" (60 short ones), "runs"
    (runs of thousands of one-position sequences among a few long ones) or
    "long" (12 of ~0.4 Mbases: ~2 M keys at a share of 0.45)."""
    if kind == "mixed":
        return [k, 300, k - 3, 700, k + 1, 64 + k - 1, 129]
    if kind == "many":
        return [k + (7 * i) % 90 for i in range(60)]
    if kind == "runs":
        return [5000] + [k] * 3000 + [4000, k - 1, k - 1] + [k] * 2500 + [3000]
    if kind == "long":
        return [400_000 + 1000 * i for i in range(12)]
    raise ValueError(kind)


def batches(lens, k: int, P: int, B: int, seed: int = 3):
    """The window batches (io/windows.py WindowRows) of random sequences
    of the given lengths, ids 0, 1, ..."""
    from twopaco_tpu_torch.passes import sortpipe

    rng = np.random.default_rng(seed)
    seqs = [(i, rng.integers(0, 4, n).astype(np.uint8)) for i, n in enumerate(lens)]
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    return sortpipe.read_batches(None, seqs, cfg, RunStats())[1]


def valid_flats(batches, P: int) -> np.ndarray:
    """Every valid flat position (row * P + col), ascending."""
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    rows = np.repeat(np.arange(len(valid)), valid)
    cols = np.arange(len(rows)) - np.repeat(np.cumsum(valid) - valid, valid)
    return rows * P + cols


def ends(batches, P: int) -> np.ndarray:
    """The first and the last flat position of every sequence."""
    seq = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    pos0 = np.concatenate([b.pos0 for b in batches])
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    n_pos = np.concatenate([b.n_pos for b in batches])
    rows = np.arange(len(seq))
    j_last = n_pos - pos0
    is_last = (seq >= 0) & (j_last >= 0) & (j_last < valid)
    return np.concatenate([rows[(seq >= 0) & (pos0 == 1)] * P,
                           rows[is_last] * P + j_last[is_last]])


def keys(batches, P: int, id_bits: int, n_table: int, at_ends: str = "random",
         share: float = 0.45, seed: int = 5) -> np.ndarray:
    """Sorted u64 keys of a random share of the valid positions, each with
    a random signed id of magnitude 1..n_table. at_ends: "stubs" leaves
    out every sequence's first and last position (a stub each), "none"
    holds them all (no stub), "random" as drawn."""
    rng = np.random.default_rng(seed)
    flats = valid_flats(batches, P)
    pick = rng.random(len(flats)) < share
    at_end = np.isin(flats, ends(batches, P))
    if at_ends == "stubs":
        pick &= ~at_end
    elif at_ends == "none":
        pick |= at_end
    flats = flats[pick]
    ids = rng.integers(1, n_table + 1, len(flats)) * rng.choice([-1, 1], len(flats))
    return (flats.astype(np.uint64) << np.uint64(id_bits)) | (
        ids + (1 << (id_bits - 1))).astype(np.uint64)
