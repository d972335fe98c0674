"""Pipeline configuration, run statistics, the junction dictionary, and
the junction-list writer (host numpy).

The port of twopaco_tpu/passes/pipeline.py:45-594. Output is
deterministic and byte-identical to the JAX package: canonical
orientation is the lexicographic min(kmer, rc), ids are ranks in the
sorted junction table, and stub ids are assigned in input order.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.io import windows

INVALID_VERTEX = (1 << 63) - 1
STUB_ID_OFFSET = 42  # reference: vertexenumerator.h:419 (verticesCount + 42)


@dataclass(frozen=True)
class PipelineConfig:
    k: int
    rounds: int = 1  # reference -r
    abundance: int = (1 << 64) - 1  # reference -a
    positions_per_row: int = 2048  # P
    rows_per_batch: int = 256  # B

    def __post_init__(self) -> None:
        # even k breaks canonicalization (palindromes tie with their own
        # reverse complement) and the all-ones sentinel assumption
        # (reference constructor.cpp:29-51)
        if self.k % 2 != 1:
            raise ValueError(f"k must be odd (got {self.k})")
        if self.k < 3:
            raise ValueError(f"k must be >= 3 (got {self.k})")

    @property
    def w(self) -> int:
        return dna.n_words(self.k)

    def window_config(self) -> windows.WindowConfig:
        return windows.WindowConfig(
            k=self.k,
            positions_per_row=self.positions_per_row,
            rows_per_batch=self.rows_per_batch,
        )


def config_from_jax(cfg) -> PipelineConfig:
    """The port's config for a twopaco_tpu PipelineConfig (read by
    attribute, so this module needs no JAX). The Bloom-engine fields
    (filter_bits, hash_functions, layout) have no counterpart: the
    sort-join engine has no filter."""
    return PipelineConfig(
        k=cfg.k,
        rounds=cfg.rounds,
        abundance=cfg.abundance,
        positions_per_row=cfg.positions_per_row,
        rows_per_batch=cfg.rows_per_batch,
    )


@dataclass
class RunStats:
    rounds: list[dict] = field(default_factory=list)
    occurrences: int = 0
    distinct_junctions: int = 0
    stub_ids: int = 0
    total_positions: int = 0
    timings: dict = field(default_factory=dict)


class Enumerator:
    """Queryable junction dictionary (reference VertexEnumerator,
    vertexenumerator.h:23-35)."""

    def __init__(self, junction_words: np.ndarray, k: int, stats: RunStats):
        self.k = k
        self.junction_words = junction_words  # (J, w) uint32, sorted
        self._keys = dna.words_to_bytes_keys(junction_words)
        self.stats = stats

    @property
    def vertices_count(self) -> int:
        return int(self.junction_words.shape[0])

    def _lookup_words(self, words: np.ndarray) -> int:
        key = dna.words_to_bytes_keys(words[None, :])[0]
        i = int(np.searchsorted(self._keys, key))
        if i < len(self._keys) and self._keys[i] == key:
            return i
        return -1

    def get_id(self, vertex: str) -> int:
        """+-(rank+1) for either strand, INVALID_VERTEX if absent
        (reference BifurcationStorage::GetId, bifurcationstorage.h:100)."""
        if len(vertex) != self.k:
            raise ValueError(f"vertex must have {self.k} chars")
        i = self._lookup_words(dna.pack_kmer_str(vertex))
        if i >= 0:
            return i + 1
        rc = dna.pack_kmers(dna.revcomp(dna.encode(vertex))[None, :], self.k)[0]
        i = self._lookup_words(rc)
        if i >= 0:
            return -(i + 1)
        return INVALID_VERTEX


def emit_junctions_packed(
    out_path: str,
    batches,
    keys: np.ndarray,
    table_len: int,
    P: int,
    timings: dict | None = None,
) -> tuple[int, int]:
    """Write the junction list from a PACKED occurrence stream: keys
    (sorted u64) = flat_pos << 32 | (signed id + 2^31). Requires flat
    positions < 2^32 and |id| < 2^31.

    Semantics are the reference EdgeConstructionWorker's
    (vertexenumerator.h:927-958): every sequence's first/last vertex
    position gets a fresh stub id when it isn't a resolved junction,
    except that stub ids here are assigned in input order.
    Returns (records_written, stub_count)."""
    t0 = time.time()
    ib = np.uint64(32)
    id_bias = np.int64(1) << 31
    seq_id = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    pos0 = np.concatenate([b.pos0 for b in batches])
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    n_pos = np.concatenate([b.n_pos for b in batches])
    rows = np.arange(len(seq_id), dtype=np.int64)
    live = seq_id >= 0

    def present(flats):
        # an occurrence at flat f has key in [f << 32, (f + 1) << 32)
        if len(keys) == 0:
            return np.zeros(len(flats), bool)
        idx = np.minimum(
            np.searchsorted(keys, flats.astype(np.uint64) << ib),
            len(keys) - 1,
        )
        return (keys[idx] >> ib).astype(np.int64) == flats

    # stubs at unresolved sequence endpoints, in stream order
    first_flat = rows * P
    pre = live & (pos0 == 1) & ~present(first_flat)
    j_last = n_pos - pos0
    is_last_row = live & (j_last >= 0) & (j_last < valid)
    last_flat = rows * P + np.where(is_last_row, j_last, 0)
    post = (
        is_last_row
        & ~present(last_flat)
        & ~(pre & (j_last == 0))  # 1-position sequence: one stub only
    )
    stub_flat = np.sort(np.concatenate([first_flat[pre], last_flat[post]]))
    stub_ids = (
        np.arange(len(stub_flat), dtype=np.int64) + table_len + STUB_ID_OFFSET
    )
    # occurrences and stubs are each sorted and disjoint: the output is
    # occurrence segments with single stub records spliced between them
    ins = np.searchsorted(keys, stub_flat.astype(np.uint64) << ib, side="left")
    if timings is not None:
        timings["emit_stub"] = time.time() - t0
    t0 = time.time()

    CH = 1 << 24
    p_shift = P.bit_length() - 1 if P & (P - 1) == 0 else None

    def map_keys(kv):
        # u32 halves through a view (little-endian: [0] = id, [1] = pos)
        halves = kv.view(np.uint32).reshape(-1, 2)
        fv, iv = halves[:, 1], halves[:, 0].astype(np.int64) - id_bias
        if p_shift is not None:
            row_of = (fv >> fv.dtype.type(p_shift)).astype(np.int64)
            col = fv & fv.dtype.type(P - 1)
        else:
            fv64 = fv.astype(np.int64)
            row_of = fv64 // P
            col = (fv64 - row_of * P).astype(np.uint32)
        return seq_id[row_of], pos0[row_of] - 1 + col, iv

    def map_flat(fv, iv):
        row_of = fv // P
        return (
            seq_id[row_of],
            (pos0[row_of] - 1 + (fv - row_of * P)).astype(np.uint32),
            iv,
        )

    def chunk_iter():
        seg_start = np.concatenate([[0], ins])
        seg_end = np.concatenate([ins, [len(keys)]])
        for si in range(len(seg_start)):
            for a in range(seg_start[si], seg_end[si], CH):
                b = min(a + CH, seg_end[si])
                yield lambda a=a, b=b: map_keys(keys[a:b])
            if si < len(stub_flat):
                yield lambda si=si: map_flat(
                    stub_flat[si : si + 1], stub_ids[si : si + 1]
                )

    # decode chunk i+1 in a thread while chunk i is written (numpy
    # releases the interpreter lock in its large passes)
    with junction_io.ChunkWriter(out_path) as w, ThreadPoolExecutor(1) as pool:
        fut = None
        for thunk in chunk_iter():
            nxt = pool.submit(thunk)
            if fut is not None:
                w.write(*fut.result())
            fut = nxt
        if fut is not None:
            w.write(*fut.result())
    if timings is not None:
        timings["emit_write"] = time.time() - t0
    return len(keys) + len(stub_flat), len(stub_flat)
