"""Pipeline configuration, run statistics, the junction dictionary, the
junction-list writer (host numpy), and the engine dispatch.

The port of twopaco_tpu/passes/pipeline.py:45-638. Output is
deterministic and byte-identical to the JAX package whatever the engine:
canonical orientation is the lexicographic min(kmer, rc), ids are ranks
in the sorted junction table, and stub ids are assigned in input order.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from twopaco_tpu_torch import dna, trace
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.io import windows
from twopaco_tpu_torch.ops import bloom

INVALID_VERTEX = (1 << 63) - 1
STUB_ID_OFFSET = 42  # reference: vertexenumerator.h:419 (verticesCount + 42)
ENGINES = ("sort", "bloom", "dist", "dist-bloom")


@dataclass(frozen=True)
class PassConfig:
    """The Bloom passes' shapes and filter (twopaco_tpu passes/kernels.py
    PassConfig): k, q hash functions, a 2^f-slot filter in `layout`
    (byte, bit or block), batches of B rows x P positions."""

    k: int
    q: int = 5
    f: int = 25
    layout: str = "byte"
    positions_per_row: int = 2048  # P
    rows_per_batch: int = 256  # B

    @property
    def w(self) -> int:
        return dna.n_words(self.k)

    @property
    def P(self) -> int:
        return self.positions_per_row

    @property
    def B(self) -> int:
        return self.rows_per_batch


@dataclass(frozen=True)
class PipelineConfig:
    k: int
    rounds: int = 1  # reference -r
    abundance: int = (1 << 64) - 1  # reference -a
    positions_per_row: int = 2048  # P
    rows_per_batch: int = 256  # B
    # most records one round may sort; None sizes the round from the
    # device's free memory (the CPU: no limit)
    sort_chunk: int | None = None
    round_slack: float = 1.25  # round buffer slack over an even split
    force_wide: bool = False  # the >= 2^32-slot merge layout on any input
    filter_bits: int = 25  # f: Bloom slots = 2^f (reference -f)
    hash_functions: int = 5  # q (reference -q)
    layout: str = "auto"  # Bloom layout: auto | byte | bit | block
    engine: str = "sort"  # sort (sort-join) | bloom | dist | dist-bloom

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

    def resolve_layout(self, shard_devices: int = 1) -> str:
        """The Bloom layout of the filter (shard) a device holds: `layout`,
        checked against its capacity, or for 'auto' the byte layout up to
        2^30 slots and the bit layout up to 2^35 (twopaco_tpu
        pipeline.py:77). shard_devices > 1: the dist-bloom engine, whose
        shards hold ceil(2^f / D) slots each, so -f 38 fits the bit layout
        over 8 shards."""
        slots = -(-(1 << self.filter_bits) // shard_devices)
        if self.layout != "auto":
            bloom.check_layout_slots(slots, self.layout)
            return self.layout
        return bloom.choose_layout_slots(slots)

    def pass_config(self, shard_devices: int = 1) -> PassConfig:
        """The Bloom passes' shapes with the layout of a filter sharded over
        shard_devices (1: one device's whole filter)."""
        return PassConfig(
            k=self.k, q=self.hash_functions, f=self.filter_bits,
            layout=self.resolve_layout(shard_devices),
            positions_per_row=self.positions_per_row,
            rows_per_batch=self.rows_per_batch,
        )

    def window_config(self) -> windows.WindowConfig:
        return windows.WindowConfig(
            k=self.k,
            positions_per_row=self.positions_per_row,
            rows_per_batch=self.rows_per_batch,
        )


def config_from_jax(cfg) -> PipelineConfig:
    """The port's config for a twopaco_tpu PipelineConfig, every field
    carried, the Bloom engine's (filter_bits, hash_functions, layout,
    engine) included (read by attribute, so this module needs no JAX)."""
    return PipelineConfig(
        k=cfg.k,
        rounds=cfg.rounds,
        abundance=cfg.abundance,
        positions_per_row=cfg.positions_per_row,
        rows_per_batch=cfg.rows_per_batch,
        sort_chunk=cfg.sort_chunk,
        round_slack=cfg.round_slack,
        force_wide=cfg.force_wide,
        filter_bits=cfg.filter_bits,
        hash_functions=cfg.hash_functions,
        layout=cfg.layout,
        engine=cfg.engine,
    )


@dataclass
class RunStats:
    rounds: list[dict] = field(default_factory=list)
    occurrences: int = 0
    distinct_junctions: int = 0
    stub_ids: int = 0
    total_positions: int = 0
    timings: dict = field(default_factory=dict)


def timed_engine(phases):
    """Run an engine (-> Enumerator) inside a `total` span and set its
    stats.timings from the spans under it: each of `phases` summed by name
    (0.0 where it did not run), then emit_stub and emit_write where the run
    wrote, and `total`."""

    def wrap(engine):
        @functools.wraps(engine)
        def run(*args, **kwargs):
            with trace.span("total") as total:
                enum = engine(*args, **kwargs)
            if enum is None:  # a test stood in for the engine's tail
                return enum
            got = trace.totals(total)
            t = {name: got.get(name, 0.0) for name in phases}
            t.update((name, got[name]) for name in ("emit_stub", "emit_write") if name in got)
            t["total"] = total.seconds
            enum.stats.timings = t
            return enum

        return run

    return wrap


def _split_rounds(hist: np.ndarray, rounds: int, bin_pow: int) -> list[tuple[int, int]]:
    """Greedy equal-mass split of the hash space into `rounds` inclusive
    uint32 intervals (reference vertexenumerator.h:206-250)."""
    if rounds <= 1:
        return [(0, 0xFFFFFFFF)]
    total = int(hist.sum())
    target = total / rounds
    bounds = []
    acc = 0
    low_bin = 0
    for b in range(len(hist)):
        acc += int(hist[b])
        if acc >= target and len(bounds) < rounds - 1:
            bounds.append((low_bin, b))
            low_bin = b + 1
            acc = 0
    bounds.append((low_bin, len(hist) - 1))
    shift = 32 - bin_pow
    out = []
    for lo_b, hi_b in bounds:
        if lo_b >= len(hist):
            # the greedy boundary consumed every bin already: this round
            # is empty, an inverted (always-false) interval keeps the
            # uint32 bounds valid and the rounds disjoint
            out.append((1, 0))
            continue
        low = lo_b << shift
        high = ((hi_b + 1) << shift) - 1 if hi_b + 1 < len(hist) else 0xFFFFFFFF
        out.append((low, high))
    return out


def _input_fingerprint(input_paths, sequences) -> str:
    """Identity of the run's input for checkpoint validation: file
    paths, sizes and mtimes when reading from disk, a content hash of the
    encoded sequences otherwise."""
    h = hashlib.blake2b(digest_size=16)
    if input_paths is not None:
        for p in input_paths:
            st = os.stat(p)
            h.update(f"{os.path.abspath(p)}:{st.st_size}:{st.st_mtime_ns};".encode())
    else:
        for sid, codes in sequences:
            h.update(f"{sid}:{len(codes)}:".encode())
            h.update(np.ascontiguousarray(codes, np.uint8).tobytes())
    return h.hexdigest()


class RoundCheckpoint:
    """Round-boundary checkpointing: each completed round's arrays and
    stats land in <dir>/round_<r>.npz, guarded by a meta.json of the run
    parameters and an input fingerprint (a mismatch clears the directory
    rather than resuming wrongly). The reference keeps intermediate files
    but has no resume; rounds are deterministic here, so completed ones
    can be reloaded verbatim. directory None: no checkpointing.
    read_only: a reader beside the one writer of a multi-process run (it
    opens after the writer has checked the directory, and writes
    nothing)."""

    def __init__(self, directory, meta: dict, read_only: bool = False):
        self.dir = directory
        self.read_only = read_only
        if directory is None or read_only:
            return
        os.makedirs(directory, exist_ok=True)
        self.meta = meta
        meta_path = os.path.join(directory, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                if json.load(f) != self.meta:
                    for fn in os.listdir(directory):
                        if fn.startswith("round_") or fn == "meta.json":
                            os.remove(os.path.join(directory, fn))
        with open(meta_path, "w") as f:
            json.dump(self.meta, f)

    def _path(self, r: int) -> str:
        return os.path.join(self.dir, f"round_{r}.npz")

    def has_round(self, r: int) -> bool:
        return self.dir is not None and os.path.exists(self._path(r))

    def load_round(self, r: int):
        """-> (arrays dict, rstats dict) or None if not checkpointed."""
        if not self.has_round(r):
            return None
        z = np.load(self._path(r), allow_pickle=False)
        rstats = json.loads(str(z["stats"]))
        return {k: z[k] for k in z.files if k != "stats"}, rstats

    def save_round(self, r: int, rstats, **arrays) -> None:
        if self.dir is None or self.read_only:
            return
        tmp = self._path(r) + ".tmp.npz"  # .npz suffix: savez won't append
        np.savez(tmp, stats=np.asarray(json.dumps(rstats)), **arrays)
        os.replace(tmp, self._path(r))


class Enumerator:
    """Queryable junction dictionary (reference VertexEnumerator,
    vertexenumerator.h:23-35)."""

    def __init__(self, junction_words: np.ndarray, k: int, stats: RunStats):
        self.k = k
        self.junction_words = junction_words  # (J, w) uint32, sorted
        with trace.span("table_keys"):
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


def _endpoint_stubs(batches, present, table_len: int, P: int):
    """Stubs at unresolved sequence endpoints, in stream order.

    Semantics are the reference EdgeConstructionWorker's
    (vertexenumerator.h:927-958): every sequence's first/last vertex
    position gets a fresh stub id when it isn't a resolved junction,
    except that stub ids here are assigned in input order.
    present(flats) says which flat positions hold an occurrence.
    -> (seq_id, pos0 per row, stub flat positions sorted, stub ids)"""
    seq_id = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    pos0 = np.concatenate([b.pos0 for b in batches])
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    n_pos = np.concatenate([b.n_pos for b in batches])
    rows = np.arange(len(seq_id), dtype=np.int64)
    live = seq_id >= 0
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
    return seq_id, pos0, stub_flat, stub_ids


def _write_spliced(out_path, n_occ: int, ins, stub_flat, stub_ids, map_occ, map_flat):
    """Write occurrence segments [ins[i-1], ins[i]) with one stub record
    spliced after each (occurrences and stubs are each sorted and
    disjoint), decoding chunk i+1 in a thread while chunk i is written
    (numpy releases the interpreter lock in its large passes).
    map_occ(a, b) decodes occurrences [a, b). The `emit_write` span counts
    the seconds the writer waits for a decode (decode_wait_s), the
    ChunkWriter's counters (assemble_s, sink_s, bytes) and card_records,
    0 here (the records built by passes/emit.py where the keys lie)."""
    CH = 1 << 24

    def chunk_iter():
        seg_start = np.concatenate([[0], ins])
        seg_end = np.concatenate([ins, [n_occ]])
        for si in range(len(seg_start)):
            for a in range(seg_start[si], seg_end[si], CH):
                b = min(a + CH, seg_end[si])
                yield lambda a=a, b=b: map_occ(a, b)
            if si < len(stub_flat):
                yield lambda si=si: map_flat(
                    stub_flat[si : si + 1], stub_ids[si : si + 1]
                )

    def decoded(fut):
        t0 = time.perf_counter_ns()
        got = fut.result()
        sp.add("decode_wait_s", (time.perf_counter_ns() - t0) / 1e9)
        return got

    with trace.span("emit_write") as sp:
        with junction_io.ChunkWriter(out_path) as w, ThreadPoolExecutor(1) as pool:
            fut = None
            for thunk in chunk_iter():
                nxt = pool.submit(thunk)
                if fut is not None:
                    w.write(*decoded(fut))
                fut = nxt
            if fut is not None:
                w.write(*decoded(fut))
        for key, val in w.counters().items():
            sp.add(key, val)
        sp.add("card_records", 0)


def _row_mapper(seq_id, pos0, P: int):
    """(flat positions, ids) -> (sequence, 0-based position, ids)."""
    p_shift = P.bit_length() - 1 if P & (P - 1) == 0 else None

    def map_flat(fv, iv):
        if p_shift is not None:  # int64 division runs ~25M/s, shifts ~500M/s
            row_of = (fv >> fv.dtype.type(p_shift)).astype(np.int64)
            col = (fv & fv.dtype.type(P - 1)).astype(np.int64)
        else:
            fv64 = fv.astype(np.int64)
            row_of = fv64 // P
            col = fv64 - row_of * P
        return seq_id[row_of], pos0[row_of] - 1 + col, iv

    return map_flat


def emit_junctions(
    out_path: str,
    batches,
    occ_pos: np.ndarray,
    occ_ids: np.ndarray,
    table_len: int,
    P: int,
) -> tuple[int, int]:
    """Write the junction list from an UNPACKED occurrence stream:
    occ_pos sorted int64 global flat positions (row * P + col) of the
    resolved junction occurrences, occ_ids their signed ids (any width).
    The emit of the unpacked merge and of the Bloom engine where the ids
    (the stubs' too) and positions do not fit one u64 key; a packed merge
    and every other Bloom run write their keys through passes/emit.py.
    Returns (records_written, stub_count)."""
    occ_pos = occ_pos.astype(np.int64, copy=False)
    occ_ids = occ_ids.astype(np.int64, copy=False)

    def present(flats):
        if len(occ_pos) == 0:
            return np.zeros(len(flats), bool)
        idx = np.minimum(np.searchsorted(occ_pos, flats), len(occ_pos) - 1)
        return occ_pos[idx] == flats

    with trace.span("emit_stub"):
        seq_id, pos0, stub_flat, stub_ids = _endpoint_stubs(batches, present, table_len, P)
        ins = np.searchsorted(occ_pos, stub_flat, side="left")
    map_flat = _row_mapper(seq_id, pos0, P)
    _write_spliced(
        out_path, len(occ_pos), ins, stub_flat, stub_ids,
        lambda a, b: map_flat(occ_pos[a:b], occ_ids[a:b]), map_flat,
    )
    return len(occ_pos) + len(stub_flat), len(stub_flat)


def build_junctions(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    tmpdir: str | None = None,
    *,
    device="cuda",
    reference: bool = False,
):
    """Run the engine config.engine names (twopaco_tpu pipeline.py:597):
    the sort-join engine (passes/sortpipe.py), the Bloom engine
    (passes/bloompipe.py; tmpdir holds its spilled candidate masks) or the
    distributed sort-join engine (parallel/distpipe.py, one shard per
    visible CUDA device, one CPU shard on the CPU), without or with its
    hash-sharded Bloom gate (dist-bloom). Arguments as
    build_junctions_sorted's. -> Enumerator."""
    if config.engine == "sort":
        from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted

        return build_junctions_sorted(
            input_paths, config, out_path, sequences, log, checkpoint_dir,
            device=device, reference=reference,
        )
    if config.engine == "bloom":
        from twopaco_tpu_torch.passes.bloompipe import build_junctions_bloom

        return build_junctions_bloom(
            input_paths, config, out_path, sequences, log, checkpoint_dir,
            tmpdir, device=device, reference=reference,
        )
    if config.engine in ("dist", "dist-bloom"):
        from twopaco_tpu_torch.parallel.distpipe import build_junctions_dist

        return build_junctions_dist(
            input_paths, config, None, out_path, sequences, log, checkpoint_dir,
            device=device, reference=reference, bloom_gate=config.engine == "dist-bloom",
        )
    raise ValueError(f"unknown engine {config.engine!r}; one of {ENGINES}")
