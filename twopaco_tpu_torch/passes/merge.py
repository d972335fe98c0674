"""The packed merge on the device: N keyed merge entries (rounds, or a
round's shards) into the global junction table and one position-sorted
key buffer.

Replaces the host merge of the JAX package
(twopaco_tpu/passes/sortpipe.py:1539-1655 merge_rounds_packed: argsort of
the tables, a numpy remap of every occurrence id, a sort of the key
buffer), which sits on the host because of the TPU's slow D2H link. An
entry is (table (nj, w) uint32 sorted, its occurrences as u64 keys
pos << id_bits | (local id + 2^(id_bits-1)) sorted by position), the
entries' k-mer sets disjoint. On the device:
  1. the concatenated tables sorted by their k-mer (passes/sort.py
     sort_records, the row index as its position column): the sorted
     words are the global table, the sorted positions the order;
  2. merge_inv (kernels/csrc/merge.cu k_merge_inv): inv[order[i]] = i,
     and a count of equal neighbours (a k-mer in two entries);
  3. merge_remap (k_merge_remap, then sort.cu's digit passes as in the
     occurrence sort, occ_pack.cu): every key's low id_bits rewritten to
     its global id, +-(inv[row_ofs[e] + |id| - 1] + 1) + bias, ids 0 and
     ids past their entry's table counted; then the keys sorted by their
     position bits alone (a flat position holds one occurrence, so this
     is the order of the whole keys: numpy's sort of the buffer).
CUDA tensors go through the kernels, CPU tensors through the plain
versions (`merge_packed_plain` composes them; torch.sort only there).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.passes import sort

def device_bytes(n_rows: int, w: int, n_keys: int, id_bits: int) -> int:
    """Device bytes of a merge of n_rows table rows of w words and n_keys
    keys: the tables (input and sorted), the sort's columns and work, inv,
    and the keys twice with their sort scratch."""
    table = n_rows * (2 * (4 * w + 12) + 4) + sort.work_bytes(n_rows, w)
    keys = 16 * n_keys + sort.scratch_bytes(n_keys, _key_passes(id_bits))
    return table + keys


def _key_passes(id_bits: int) -> int:
    return -(-(64 - id_bits) // sort.RADIX_BITS)


def _check_entries(keys, entries) -> None:
    if entries.dim() != 2 or entries.shape[0] != 2 or entries.shape[1] < 2:
        raise ValueError(f"entries must be (2, N+1), got {tuple(entries.shape)}")
    if keys.dim() != 1:
        raise ValueError("keys must be one-dimensional")


def _check_bits(id_bits: int) -> None:
    if not 2 <= id_bits <= 62:
        raise ValueError(f"id_bits {id_bits} outside [2, 62]")


def merge_inv_plain(words, order):
    """Plain PyTorch version of merge_inv (any device)."""
    m = words.shape[0]
    inv = torch.empty(m, dtype=torch.int32, device=words.device)
    inv[order] = torch.arange(m, dtype=torch.int32, device=words.device)
    w32 = words.view(torch.int32)
    dup = (w32[1:] == w32[:-1]).all(dim=1).sum().reshape(1) if m > 1 else (
        torch.zeros(1, dtype=torch.int64, device=words.device))
    return inv, dup


def merge_inv(words, order):
    """words (m, w) uint32 sorted rows, order (m,) int64: the sorted rows'
    rows before the sort (a permutation). -> (inv (m,) int32, inv[order[i]]
    = i; dup (1,) int64: rows equal to the row before them)."""
    if build.on_cpu(words, order):
        return merge_inv_plain(words, order)
    build.require(words, torch.uint32, "words")
    build.require(order, torch.int64, "order")
    m, w = words.shape
    if order.shape != (m,):
        raise ValueError("order must have one entry a row")
    if m >= 1 << 31:
        raise ValueError(f"{m} rows exceed the merge's int32 ids")
    inv = torch.empty(m, dtype=torch.int32, device=words.device)
    dup = torch.zeros(1, dtype=torch.int64, device=words.device)
    rc = build.lib().tp_merge_inv(words.data_ptr(), order.data_ptr(), m, w, inv.data_ptr(),
                                  dup.data_ptr(), build.stream_ptr())
    build.check(rc, "merge_inv")
    build.count_launch("merge_inv")
    return inv, dup


def merge_remap_plain(keys, entries, inv, *, id_bits: int):
    """Plain PyTorch version of merge_remap (any device)."""
    _check_bits(id_bits)
    _check_entries(keys, entries)
    dev, n = keys.device, keys.numel()
    mask = (1 << id_bits) - 1
    bias = 1 << (id_bits - 1)
    key_ofs, row_ofs = entries[0], entries[1]
    e = torch.searchsorted(key_ofs[1:], torch.arange(n, device=dev), right=True)
    ids = (keys & mask) - bias
    mag = ids.abs()
    id0 = ids == 0
    past = ~id0 & ((mag > (row_ofs[1:] - row_ofs[:-1])[e]) | (row_ofs[e] + mag > inv.numel()))
    ok = ~(id0 | past)
    if inv.numel():
        g = inv[(row_ofs[e] + mag - 1).clamp(0, inv.numel() - 1)].to(torch.int64) + 1
    else:
        g = torch.ones_like(keys)
    gid = torch.where(ids < 0, -g, g) + bias
    new = torch.where(ok, (keys & ~mask) | gid, keys)
    pos = (new >> id_bits) & ((1 << (64 - id_bits)) - 1)
    keys.copy_(new[torch.sort(pos, stable=True).indices])
    return keys, torch.stack([id0.sum(), past.sum()])


def merge_remap(keys, entries, inv, *, id_bits: int):
    """Rewrite each key's id to its global id, then sort the keys by
    position, in place.

    keys: (n,) int64 holding u64 keys, the entries' position-sorted runs
    concatenated; entries: (2, N+1) int64, row 0 the runs' key offsets
    (0 .. n), row 1 the entries' table row offsets in the concatenated
    tables (0 .. inv's length); inv: merge_inv's. -> (keys, sorted by
    position; faults (2,) int64: keys whose id is 0, whose |id| passes its
    entry's table (or inv); their keys are left as they were)."""
    if build.on_cpu(keys, entries, inv):
        return merge_remap_plain(keys, entries, inv, id_bits=id_bits)
    build.require(keys, torch.int64, "keys")
    build.require(entries, torch.int64, "entries")
    build.require(inv, torch.int32, "inv")
    _check_bits(id_bits)
    _check_entries(keys, entries)
    n = keys.numel()
    if n >= 1 << 32:
        raise ValueError(f"{n} keys exceed the sort's u32 counts")
    dev = keys.device
    alt = torch.empty_like(keys)
    work = sort.scratch(n, _key_passes(id_bits), dev)
    faults = torch.zeros(2, dtype=torch.int64, device=dev)
    rc = build.lib().tp_merge_remap(
        keys.data_ptr(), n, entries.data_ptr(), entries.shape[1] - 1, inv.data_ptr(),
        inv.numel(), id_bits, alt.data_ptr(), work.data_ptr(), work.numel(),
        faults.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "merge_remap")
    build.count_launch("merge_remap")
    return keys, faults


def _merge(table, keys, entries, key_bits, id_bits, sort_fn, inv_fn, remap_fn):
    rows = table.shape[0]
    dev = table.device
    srt, _pay, order = sort_fn(
        table, torch.zeros(rows, dtype=torch.int32, device=dev).view(torch.uint32),
        torch.arange(rows, dtype=torch.int64, device=dev), key_bits=key_bits)
    inv, dup = inv_fn(srt, order)
    del order
    keys, faults = remap_fn(keys, entries, inv, id_bits=id_bits)
    return srt, keys, torch.cat([dup, faults])


def merge_packed(table, keys, entries, *, key_bits: int, id_bits: int):
    """The merge of N keyed entries on the tensors' device.

    table: (T, w) uint32, the entries' tables concatenated; keys: (n,)
    int64, their key runs concatenated (rewritten and sorted in place);
    entries: (2, N+1) int64 as merge_remap takes it; key_bits: 2k.
    -> (the global table (T, w) uint32, keys sorted, faults (3,) int64:
    duplicate k-mers, ids 0, ids past their table; the caller raises on
    any)."""
    return _merge(table, keys, entries, key_bits, id_bits, sort.sort_records, merge_inv,
                  merge_remap)


def merge_packed_plain(table, keys, entries, *, key_bits: int, id_bits: int):
    """merge_packed through the plain versions (any device)."""
    return _merge(table, keys, entries, key_bits, id_bits, sort.sort_records_plain,
                  merge_inv_plain, merge_remap_plain)
