"""The emit of every packed merge: the junction list of the merged keys
built where they lie, and streamed to the file in chunks.

A packed merge (passes/sortpipe.py merge_rounds_packed) ends with ~2
occurrences per input k-mer position as position-sorted u64 keys
(passes/occ.py: key = flat << id_bits | (signed id + 2^(id_bits-1))): on
the card after a one-round build or a device merge, on the host after the
host merge or a build on the CPU. The host answers where each record
goes from a few queries and receives the records whole, built where the
keys lie (kernels/csrc/emit.cu on a card, the plain versions on the CPU):

  1. check_keys (in the merge): one launch counts the keys' faults (an id
     0, an |id| past the table, a position outside its row's valid
     positions, a key not above its predecessor) and answers the host's
     queries: the lower bound of the first and last position of every
     row (the stubs' presence test, pipeline._endpoint_stubs, and the
     occurrences before each row) and the keys at the chunks' edges. A
     fault raises here, before the output file is opened, with the
     merges' messages;
  2. write_keys (the emit): the host places every record (a few numpy
     passes over the rows, none over the keys): occurrence i goes to
     slot i + base[row] (base = its sequence id, the separators written
     before it, plus the stubs at or before its row's first position);
     the stubs and separators are a short list of (slot, record). One
     launch a chunk of CHUNK occurrences (fewer where the free device
     memory asks, chunk_size) builds the chunk's records where the keys
     lie; on a card the chunk is copied into one of two host buffers,
     page-locked for the emit, while the writer puts the previous chunk
     into the file.

The bytes are ChunkWriter's (io/junctions.py) for the same keys. The
records' sequence ids must not fall from row to row (check_keys raises;
the engines' inputs count up from 0). CUDA tensors go through the
kernels, CPU tensors through the plain versions (check_plain,
chunk_plain).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from twopaco_tpu_torch import hostmem, trace
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.passes.pipeline import _endpoint_stubs

CHUNK = 1 << 24  # occurrences a chunk: ~200 MB of records
_SIGN = -(1 << 63)  # x ^ _SIGN orders int64-held u64 values as int64


def _fields(keys, P: int, id_bits: int):
    """-> (flat, row, col, signed id) int64 tensors of int64-held u64 keys."""
    flat = (keys >> id_bits) & ((1 << (64 - id_bits)) - 1)
    row = torch.div(flat, P, rounding_mode="floor")
    ids = (keys & ((1 << id_bits) - 1)) - (1 << (id_bits - 1))
    return flat, row, flat - row * P, ids


def check_plain(keys, valid, queries, at, *, P: int, id_bits: int, n_table: int):
    """Plain PyTorch version of check (any device)."""
    n = keys.numel()
    flat, row, col, ids = _fields(keys, P, id_bits)
    n_rows = valid.numel()
    in_rows = row < n_rows
    row_valid = (valid.to(torch.int64)[row.clamp(max=max(n_rows - 1, 0))] if n_rows
                 else torch.zeros_like(row))
    ordered = keys ^ _SIGN
    faults = torch.stack([
        (ids.abs() > n_table).sum(), (ids == 0).sum(), (~in_rows | (col >= row_valid)).sum(),
        (ordered[1:] <= ordered[:-1]).sum(),
    ])
    lower = torch.searchsorted(ordered, (queries << id_bits) ^ _SIGN)
    hit = torch.zeros_like(lower)
    if n:
        hit = ((lower < n) & (flat[lower.clamp(max=n - 1)] == queries)).to(torch.int64)
    inside = (at >= 0) & (at < n)
    at_keys = torch.where(inside, keys[at.clamp(0, max(n - 1, 0))] if n else at, 0)
    return faults, lower, hit, at_keys


def check(keys, valid, queries, at, *, P: int, id_bits: int, n_table: int):
    """The keys' faults and the host's queries, on the keys' device
    (tp_emit_check).

    keys (n,) int64 holding the u64 keys; valid (n_rows,) int32, each
    row's valid positions; queries (nq,) int64 flat positions; at (na,)
    int64 key indices. -> (faults (4,) int64: ids whose |id| passes
    n_table, ids 0, keys whose position lies outside its row's valid
    positions, keys not above their predecessor; lower (nq,) int64, the
    first key at or past each query's position; hit (nq,) int64, 1 where
    that key is at the query's position; at_keys (na,) int64, the keys at
    `at`, 0 past the keys). Nothing is read back to the host."""
    if build.on_cpu(keys, valid, queries, at):
        return check_plain(keys, valid, queries, at, P=P, id_bits=id_bits, n_table=n_table)
    for t, dtype, name in ((keys, torch.int64, "keys"), (valid, torch.int32, "valid"),
                           (queries, torch.int64, "queries"), (at, torch.int64, "at")):
        build.require(t, dtype, name)
    dev = keys.device
    nq, na = queries.numel(), at.numel()
    faults = torch.zeros(4, dtype=torch.int64, device=dev)
    lower, hit = (torch.empty(nq, dtype=torch.int64, device=dev) for _ in "lh")
    at_keys = torch.empty(na, dtype=torch.int64, device=dev)
    rc = build.lib().tp_emit_check(
        keys.data_ptr(), keys.numel(), id_bits, n_table, P, valid.data_ptr(), valid.numel(),
        queries.data_ptr(), nq, lower.data_ptr(), hit.data_ptr(), at.data_ptr(), na,
        at_keys.data_ptr(), faults.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "emit_check")
    build.count_launch("emit_check")
    return faults, lower, hit, at_keys


def _as_int32(x):
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def chunk_plain(keys, rows, gap_slots, gap_recs, out, *, i0: int, i1: int, s0: int, P: int,
                id_bits: int):
    """Plain PyTorch version of chunk (any device)."""
    _flat, row, col, ids = _fields(keys[i0:i1], P, id_bits)
    rec = out.view(-1, 3)
    slot = torch.arange(i0, i1, device=keys.device) + rows[row, 0] - s0
    rec[slot, 0] = _as_int32((rows[row, 1] + col) & 0xFFFFFFFF)
    rec[slot, 1:] = ids.contiguous().view(torch.int32).view(-1, 2)
    sel = (gap_slots >= s0) & (gap_slots < s0 + rec.shape[0])
    rec[gap_slots[sel] - s0] = gap_recs[sel]
    return out


def chunk(keys, rows, gap_slots, gap_recs, out, *, i0: int, i1: int, s0: int, P: int,
          id_bits: int):
    """One chunk of the junction list's records into out (tp_emit_chunk):
    occurrences [i0, i1) of keys at slots i + rows[row, 0], each (u32
    rows[row, 1] + col, its signed id), and the gap records (gap_slots
    (ng,) int64 ascending, gap_recs (ng, 3) int32) whose slot lies in the
    chunk's slots [s0, s0 + len(out) / 3). out: int32, three words a
    record (16-byte aligned on the card)."""
    if build.on_cpu(keys, rows, gap_slots, gap_recs, out):
        return chunk_plain(keys, rows, gap_slots, gap_recs, out, i0=i0, i1=i1, s0=s0, P=P,
                           id_bits=id_bits)
    for t, dtype, name in ((keys, torch.int64, "keys"), (rows, torch.int64, "rows"),
                           (gap_slots, torch.int64, "gap_slots"),
                           (gap_recs, torch.int32, "gap_recs"), (out, torch.int32, "out")):
        build.require(t, dtype, name)
    if out.numel() % 3 or not 0 <= i0 <= i1 <= keys.numel():
        raise ValueError("out must hold whole records and [i0, i1) lie in the keys")
    rc = build.lib().tp_emit_chunk(
        keys.data_ptr(), i0, i1, s0, s0 + out.numel() // 3, rows.data_ptr(),
        gap_slots.data_ptr(), gap_recs.data_ptr(), gap_slots.numel(), P, id_bits,
        out.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "emit_chunk")
    build.count_launch("emit_chunk")
    return out


# ---- the host's side ---------------------------------------------------


def table_bytes(batches) -> int:
    """Device bytes of the card emit beside the keys and a chunk's
    occurrences, at most: its tables (rows, queries, the stub and
    separator records: at most two stubs a row and one separator a
    sequence id) and the gap records' room in its two chunk buffers."""
    n_rows = sum(len(b.seq_id) for b in batches)
    gaps = 2 * n_rows + max(max(int(b.seq_id.max()) for b in batches), 0)
    return 64 * n_rows + 20 * gaps + 2 * 12 * gaps


def chunk_size(batches, free: int | None) -> int:
    """Occurrences a chunk: CHUNK, or fewer where the card emit's tables
    and two chunk buffers (12 bytes a record) would not fit `free` device
    bytes beside the keys (None: no limit). Raises when even one
    occurrence a chunk does not fit."""
    tables = table_bytes(batches)
    if free is None:
        return CHUNK
    if free < tables + 2 * 12:
        raise RuntimeError(f"the card emit's tables need {tables + 2 * 12} bytes of device "
                           f"memory, {free} are free")
    return min(CHUNK, (free - tables) // (2 * 12))


@dataclass(frozen=True)
class Found:
    """What the check found: its queries (sorted, unique flats) with their
    lower bounds and hits, and the chunks' occurrence edges with the keys
    just before each inner edge."""

    queries: np.ndarray
    lower: np.ndarray
    hit: np.ndarray
    edges: list
    edge_keys: np.ndarray

    def _at(self, flats):
        idx = np.searchsorted(self.queries, flats)
        assert np.array_equal(self.queries[idx], flats), "a flat the check was not asked"
        return idx

    def lower_of(self, flats) -> np.ndarray:
        return self.lower[self._at(flats)]

    def present(self, flats) -> np.ndarray:
        return self.hit[self._at(flats)].astype(bool)


def check_inputs(batches, n_occ: int, P: int, dev, chunk_occ: int = CHUNK):
    """check's inputs beside the keys for n_occ occurrences in chunks of
    chunk_occ -> (the chunks' occurrence edges, the queries (numpy), and
    (valid, queries, at) on dev)."""
    asked = []  # the flats whose presence _endpoint_stubs tests

    def ask(flats):
        asked.append(flats)
        return np.zeros(len(flats), bool)

    _endpoint_stubs(batches, ask, 0, P)
    queries = np.unique(np.concatenate(asked))
    valid = np.concatenate([b.valid for b in batches])
    edges = list(range(0, n_occ, chunk_occ)) + [n_occ] if n_occ else [0, 0]
    at = np.asarray(edges[1:-1], np.int64) - 1
    return edges, queries, tuple(torch.from_numpy(a).to(dev) for a in (
        valid.astype(np.int32), queries, at))


def check_keys(keys, batches, n_table: int, P: int, id_bits: int, *, chunk_occ: int = CHUNK,
               fn=check) -> Found:
    """Check the merged keys (on their device) and answer the emit's
    queries, in one call of fn (check, or check_plain) and one copy back;
    raise on a fault, with the merges' messages for the ids. Rows whose
    sequence ids fall raise ValueError: the emit places separators by
    counting up to each sequence's id."""
    seq_id = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    if (np.diff(seq_id[seq_id >= 0]) < 0).any():
        raise ValueError("the emit takes sequence ids in input order (0, 1, ...): "
                         "these fall")
    edges, queries, args = check_inputs(batches, keys.numel(), P, keys.device, chunk_occ)
    flat = torch.cat(fn(keys, *args, P=P, id_bits=id_bits, n_table=n_table)).cpu().numpy()
    nq = len(queries)
    past, zero, outside, order = (int(x) for x in flat[:4])
    if past:
        raise RuntimeError(f"occurrence id out of range: an |id| past table size {n_table}")
    if zero:
        raise RuntimeError("occurrence id 0 (corrupt round)")
    if outside:
        raise RuntimeError(f"occurrence position outside the input's positions ({outside} "
                           "keys; corrupt round)")
    if order:
        raise RuntimeError(f"occurrence keys out of position order ({order}; corrupt round)")
    return Found(queries, flat[4 : 4 + nq], flat[4 + nq : 4 + 2 * nq], edges,
                 flat[4 + 2 * nq :])


@dataclass(frozen=True)
class Plan:
    """Where every record goes: rows (n_rows, 2) int64 (slot base,
    position base), the gap records (stubs and separators) by slot, and
    each chunk's (i0, i1, s0, s1): occurrences [i0, i1) into slots
    [s0, s1)."""

    rows: np.ndarray
    gap_slots: np.ndarray
    gap_recs: np.ndarray
    bounds: list
    n_stubs: int


def plan(batches, found: Found, n_occ: int, n_table: int, P: int, id_bits: int) -> Plan:
    """The records' places (host numpy over the rows and the stubs; the
    bytes ChunkWriter writes for the same occurrences and stubs)."""
    seq_id, pos0, stub_flat, stub_ids = _endpoint_stubs(batches, found.present, n_table, P)
    first = np.arange(len(seq_id), dtype=np.int64) * P
    base = seq_id + np.searchsorted(stub_flat, first, side="right")
    rows = np.ascontiguousarray(np.stack([base, (pos0 - 1) & 0xFFFFFFFF], axis=1))
    # stubs: after the occurrences before them and the stubs before them
    s_row = stub_flat // P
    stub_slot = (found.lower_of(stub_flat) + np.arange(len(stub_flat)) + seq_id[s_row])
    stub_pos = (pos0[s_row] - 1 + stub_flat - s_row * P) & 0xFFFFFFFF
    # separators: seq - prev of them before each sequence's first record
    # (every sequence with rows has one at its first position)
    starts = np.flatnonzero((seq_id >= 0) & (pos0 == 1))
    chr_ = seq_id[starts]
    prev = np.concatenate([[0], chr_[:-1]])
    m = found.lower_of(first[starts]) + np.searchsorted(stub_flat, first[starts], side="left")
    cnt = chr_ - prev
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    sep_slot = np.repeat(m + prev, cnt) + within
    gap_slots = np.concatenate([stub_slot, sep_slot]).astype(np.int64)
    recs = np.empty((len(gap_slots), 3), np.uint32)
    recs[:, 0] = np.concatenate([stub_pos, np.full(len(sep_slot), junction_io.SEPARATOR_POS)])
    ids = np.concatenate([stub_ids, np.full(len(sep_slot), junction_io.SEPARATOR_ID)])
    recs[:, 1:] = ids.view(np.uint32).reshape(-1, 2)
    order = np.argsort(gap_slots, kind="stable")
    total = n_occ + len(stub_flat) + (int(chr_[-1]) if len(chr_) else 0)
    edge_flat = found.edge_keys.view(np.uint64) >> np.uint64(id_bits)
    edge_slot = (np.asarray(found.edges[1:-1], np.int64) - 1
                 + base[(edge_flat // np.uint64(P)).astype(np.int64)])
    s = [0, *(edge_slot + 1).tolist(), total]
    e = found.edges
    bounds = [(e[c], e[c + 1], s[c], s[c + 1]) for c in range(len(e) - 1)]
    return Plan(rows, gap_slots[order], recs[order].view(np.int32), bounds, len(stub_flat))


def write_keys(out_path: str, batches, keys, found: Found, n_table: int, P: int,
               id_bits: int, *, fn=chunk) -> tuple[int, int]:
    """Write the junction list of the merged keys (int64-held u64,
    checked by check_keys) where they lie: fn (chunk, or chunk_plain)
    builds each chunk there; on a card each chunk is copied into one of
    two host buffers page-locked for the emit while the previous one goes
    to the file. Spans `emit_stub` (the plan) and `emit_write` with
    pipeline.emit_junctions' counters (decode_wait_s: the writer's wait
    for a chunk) and card_records (the records built here). ->
    (records written, stub count), as pipeline.emit_junctions."""
    n_occ = keys.numel()
    with trace.span("emit_stub"):
        pl = plan(batches, found, n_occ, n_table, P, id_bits)
    dev = keys.device
    on_card = dev.type == "cuda"
    rows, gap_slots, gap_recs = (torch.from_numpy(a).to(dev)
                                 for a in (pl.rows, pl.gap_slots, pl.gap_recs))
    cap = max(s1 - s0 for _i0, _i1, s0, s1 in pl.bounds)
    n_buf = min(2, len(pl.bounds))
    with trace.span("emit_write") as sp:
        dbuf = [torch.empty(3 * cap, dtype=torch.int32, device=dev) for _ in range(n_buf)]
        hbuf = [hostmem.host_empty((3 * cap,), torch.int32) for _ in range(n_buf)] \
            if on_card else dbuf
        wait_ns = 0

        def put(done, host):
            nonlocal wait_ns
            if done is not None:
                t0 = time.perf_counter_ns()
                done.synchronize()
                wait_ns += time.perf_counter_ns() - t0
            w.write_raw(host.numpy())

        with junction_io.ChunkWriter(out_path) as w, hostmem.pinned(hbuf, dev):
            pending = None
            for c, (i0, i1, s0, s1) in enumerate(pl.bounds):
                d, h = dbuf[c % n_buf][: 3 * (s1 - s0)], hbuf[c % n_buf][: 3 * (s1 - s0)]
                fn(keys, rows, gap_slots, gap_recs, d, i0=i0, i1=i1, s0=s0, P=P,
                   id_bits=id_bits)
                done = None
                if on_card:
                    h.copy_(d, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                if pending is not None:
                    put(*pending)
                pending = (done, h)
            put(*pending)
        sp.add("decode_wait_s", wait_ns / 1e9)
        for key, val in w.counters().items():
            sp.add(key, val)
        sp.add("card_records", n_occ + pl.n_stubs)
    return n_occ + pl.n_stubs, pl.n_stubs
