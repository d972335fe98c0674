"""The packed merge on the device: N keyed merge entries (rounds, or a
round's shards) into the global junction table and one position-sorted
key buffer.

Replaces the host merge of the JAX package
(twopaco_tpu/passes/sortpipe.py:1539-1655 merge_rounds_packed: argsort of
the tables, a numpy remap of every occurrence id, a sort of the key
buffer), which sits on the host because of the TPU's slow D2H link. An
entry is (table (nj, w) uint32 sorted, its occurrences as u64 keys
pos << id_bits | (local id + 2^(id_bits-1)) sorted by position), the
entries' k-mer sets disjoint. Both halves are merges of sorted runs
(kernels/csrc/merge.cu, merge path over tiles of output ranks):
  1. merge_rows (tp_merge_rows): the tables' rows, compared as w unsigned
     words word 0 first (the order of the sort by the 2k key bits: the
     bits below are zero), merged into the global table; inv maps each
     concatenated row to its global row; rows equal to the row before
     them are counted (a k-mer in two entries);
  2. merge_keys (tp_merge_keys): the key runs merged by position (the
     bits above id_bits; a flat position holds one occurrence, so that is
     numpy's sort of the buffer), each id rewritten to its global id,
     +-(inv[row_ofs[e] + |id| - 1] + 1) + bias; ids 0 and ids past their
     entry's table counted, their keys kept as they were.
Equal elements keep their entry order (a stable merge). More than FAN_IN
entries merge in rounds of FAN_IN: a round reads and writes the data once
more, but a merge's split ranks its samples against N - 1 runs, S = tile
/ 2N elements apart, so one wide merge costs more (dist D=4 -r 4's 16
entries: PERF.md row 18). CUDA tensors go
through the kernels, CPU tensors through the plain versions
(`merge_packed_plain` composes them; torch.sort only there).
merge_splits_plain is the kernels' split arithmetic, for the tests.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack

FAN_IN = 4  # runs a merge takes at once; more merge in rounds of FAN_IN
FAN_MAX = 32  # the kernels' fan-in at most: a warp's lanes rank a sample
_SMEM_WORDS = 2048  # u32 words of a tile's elements (merge.cu stages up to twice that)


def default_tile(ew: int) -> int:
    """Output elements a tile block takes for elements of ew u32 words: the
    largest power of two whose tile holds at most _SMEM_WORDS words."""
    return 1 << max(0, (_SMEM_WORDS // ew).bit_length() - 1)


def n_rounds(n_entries: int, fan: int = FAN_IN) -> int:
    """Rounds of a merge of n_entries runs, fan runs a merge."""
    rounds, runs = 1, fan
    while runs < n_entries:
        rounds, runs = rounds + 1, runs * fan
    return rounds


def sample_stride(tile: int, n_runs: int) -> int:
    """S: every S-th element of a run is a sample of the split (merge.cu
    k_merge_split), so that a tile's windows hold at most 2 * tile
    elements (the lanes of a split, a power of two >= n_runs, 2S each)."""
    lanes = 1 << max(0, (n_runs - 1).bit_length())
    return max(1, tile // (2 * lanes))


def split_len(n: int, n_entries: int, tile: int, fan: int = FAN_IN) -> int:
    """int64 entries of the split table of a merge of n elements in
    n_entries runs: (L, U) a (group of the first round, tile boundary,
    run of the group)."""
    groups = -(-n_entries // fan)
    return groups * (-(-n // tile) + 1) * min(fan, n_entries) * 2


def buffers(n_rows: int, w: int, n_keys: int, n_entries: int) -> dict[str, int]:
    """Device bytes of each buffer of merge_packed on n_rows table rows of
    w words and n_keys keys: the inputs, the outputs, inv, the two split
    tables and, past FAN_IN entries, the earlier rounds' outputs."""
    out = {
        "table": 4 * w * n_rows, "table out": 4 * w * n_rows, "inv": 4 * n_rows,
        "keys": 8 * n_keys, "keys out": 8 * n_keys, "entries": 16 * (n_entries + 1),
        "row splits": 8 * split_len(n_rows, n_entries, default_tile(w)),
        "key splits": 8 * split_len(n_keys, n_entries, default_tile(2)),
    }
    if n_rounds(n_entries) > 1:
        out.update({"table tmp": 4 * w * n_rows, "inv tmp": 4 * n_rows, "keys tmp": 8 * n_keys})
    return out


def device_bytes(n_rows: int, w: int, n_keys: int, n_entries: int) -> int:
    """Device bytes of a merge of n_rows table rows of w words and n_keys
    keys in n_entries entries (the sum of `buffers`)."""
    return sum(buffers(n_rows, w, n_keys, n_entries).values())


def _check_entries(keys, entries) -> None:
    if entries.dim() != 2 or entries.shape[0] != 2 or entries.shape[1] < 2:
        raise ValueError(f"entries must be (2, N+1), got {tuple(entries.shape)}")
    if keys.dim() != 1:
        raise ValueError("keys must be one-dimensional")


def _check_bits(id_bits: int) -> None:
    if not 2 <= id_bits <= 62:
        raise ValueError(f"id_bits {id_bits} outside [2, 62]")


def _check_ofs(ofs) -> None:
    if ofs.dim() != 1 or ofs.numel() < 2:
        raise ValueError(f"offsets must be (N+1,) with N >= 1, got {tuple(ofs.shape)}")


def _check_tiling(tile: int, fan: int) -> None:
    if not 2 <= fan <= FAN_MAX:
        raise ValueError(f"fan {fan} outside [2, {FAN_MAX}]")
    if tile < 1:
        raise ValueError(f"tile {tile} < 1")


def row_values(table):
    """(T,) int64: each row's rank among the distinct rows of table (w
    words compared word 0 first): the rows' order as one integer."""
    if table.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=table.device)
    return torch.unique(pack.as_i64(table), dim=0, return_inverse=True)[1]


def key_values(keys, id_bits: int):
    """(n,) int64: the keys' positions, the bits above id_bits."""
    return (keys >> id_bits) & ((1 << (64 - id_bits)) - 1)


def merge_splits_plain(values, ofs, *, tile: int):
    """The split table of one merge group as k_merge_split computes it:
    values (n,) int64, the order of the elements (each run of `ofs` (N+1,)
    ascending); -> (ceil(n / tile) + 1, N, 2) int64 (L, U): at boundary t
    (t * tile, n for the last), the elements of run f that rank before it
    in the stable merge number in [L, U]. A sample (every S-th element of
    a run) ranks by searches of the other runs; L = i * S + 1 for the last
    sample i ranking before the boundary (0 for none), U = the next
    sample's index (the run's length for none)."""
    _check_ofs(ofs)
    _check_tiling(tile, FAN_MAX)
    n_runs = ofs.numel() - 1
    if n_runs > FAN_MAX:
        raise ValueError(f"{n_runs} runs in one group of at most {FAN_MAX}")
    S = sample_stride(tile, n_runs)
    n = values.numel()
    ntiles = -(-n // tile)
    bounds = torch.arange(ntiles + 1, dtype=torch.int64, device=values.device) * tile
    bounds[-1] = n
    o = ofs.tolist()
    runs = [values[o[f] : o[f + 1]] for f in range(n_runs)]
    table = torch.zeros((ntiles + 1, n_runs, 2), dtype=torch.int64, device=values.device)
    for f, run in enumerate(runs):
        if not len(run):
            continue
        idx = torch.arange(0, len(run), S, dtype=torch.int64, device=values.device)
        rank = idx.clone()
        for h, other in enumerate(runs):
            if h != f:
                rank += torch.searchsorted(other, run[idx], right=h < f)
        m = torch.searchsorted(rank, bounds)  # samples ranking before each boundary
        table[:, f, 0] = torch.where(m > 0, (m - 1) * S + 1, 0)
        table[:, f, 1] = torch.where(m < len(idx), m * S, len(run))
    return table


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def merge_rows_plain(table, row_ofs):
    """Plain PyTorch version of merge_rows (any device): a stable sort of
    the concatenated rows."""
    _check_ofs(row_ofs)
    vals = row_values(table)
    srt, order = torch.sort(vals, stable=True)
    T = table.shape[0]
    inv = torch.empty(T, dtype=torch.int32, device=table.device)
    inv[order] = torch.arange(T, dtype=torch.int32, device=table.device)
    dup = (srt[1:] == srt[:-1]).sum().reshape(1)
    return pack.take_u32(table, order), inv, dup


def merge_rows(table, row_ofs, *, tile: int | None = None, fan: int = FAN_IN):
    """The stable merge of sorted tables.

    table: (T, w) uint32, N sorted tables concatenated; row_ofs: (N+1,)
    int64, their offsets (0 .. T). tile (output rows a block) and fan (runs
    a merge round) are for the tests. -> (the global table (T, w) uint32;
    inv (T,) int32, the global row of each concatenated row; dup (1,)
    int64: rows equal to the row before them)."""
    if build.on_cpu(table, row_ofs):
        return merge_rows_plain(table, row_ofs)
    build.require(table, torch.uint32, "table")
    build.require(row_ofs, torch.int64, "row_ofs")
    T, w = table.shape
    tile = tile or default_tile(w)
    _check_ofs(row_ofs)
    _check_tiling(tile, fan)
    if T >= 1 << 31:
        raise ValueError(f"{T} rows exceed the merge's int32 ids")
    n_entries = row_ofs.numel() - 1
    dev = table.device
    out = torch.empty_like(table)
    inv = torch.empty(T, dtype=torch.int32, device=dev)
    dup = torch.zeros(1, dtype=torch.int64, device=dev)
    if T == 0:
        return out, inv, dup
    wt = torch.empty(split_len(T, n_entries, tile, fan), dtype=torch.int64, device=dev)
    many = n_rounds(n_entries, fan) > 1
    tmp = torch.empty_like(table) if many else None
    tmp_inv = torch.empty(T, dtype=torch.int32, device=dev) if many else None
    rc = build.lib().tp_merge_rows(
        table.data_ptr(), T, w, row_ofs.data_ptr(), n_entries, fan, tile, out.data_ptr(),
        inv.data_ptr(), dup.data_ptr(), wt.data_ptr(), wt.numel(), _ptr(tmp), _ptr(tmp_inv),
        build.stream_ptr(),
    )
    build.check(rc, "merge_rows")
    build.count_launch("merge_rows")
    return out, inv, dup


def merge_keys_plain(keys, entries, inv, *, id_bits: int):
    """Plain PyTorch version of merge_keys (any device): the ids rewritten,
    then a stable sort by position."""
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
    order = torch.sort(key_values(keys, id_bits), stable=True).indices
    return new[order], torch.stack([id0.sum(), past.sum()])


def merge_keys(keys, entries, inv, *, id_bits: int, tile: int | None = None,
               fan: int = FAN_IN):
    """The stable merge of position-sorted key runs, each id rewritten to
    its global id.

    keys: (n,) int64 holding u64 keys, the entries' runs concatenated;
    entries: (2, N+1) int64, row 0 the runs' key offsets (0 .. n), row 1
    the entries' table row offsets in the concatenated tables (0 .. inv's
    length); inv: merge_rows's. tile, fan: as merge_rows takes them. ->
    (the keys with global ids in position order, a new tensor; faults (2,)
    int64: keys whose id is 0, whose |id| passes its entry's table (or
    inv); their keys keep their ids)."""
    if build.on_cpu(keys, entries, inv):
        return merge_keys_plain(keys, entries, inv, id_bits=id_bits)
    build.require(keys, torch.int64, "keys")
    build.require(entries, torch.int64, "entries")
    build.require(inv, torch.int32, "inv")
    _check_bits(id_bits)
    _check_entries(keys, entries)
    tile = tile or default_tile(2)
    _check_tiling(tile, fan)
    n, n_entries = keys.numel(), entries.shape[1] - 1
    dev = keys.device
    out = torch.empty_like(keys)
    faults = torch.zeros(2, dtype=torch.int64, device=dev)
    if n == 0:
        return out, faults
    wt = torch.empty(split_len(n, n_entries, tile, fan), dtype=torch.int64, device=dev)
    tmp = torch.empty_like(keys) if n_rounds(n_entries, fan) > 1 else None
    rc = build.lib().tp_merge_keys(
        keys.data_ptr(), n, entries.data_ptr(), n_entries, inv.data_ptr(), inv.numel(), id_bits,
        fan, tile, out.data_ptr(), faults.data_ptr(), wt.data_ptr(), wt.numel(), _ptr(tmp),
        build.stream_ptr(),
    )
    build.check(rc, "merge_keys")
    build.count_launch("merge_keys")
    return out, faults


def _merge(table, keys, entries, key_bits, id_bits, rows_fn, keys_fn):
    if key_bits > 32 * table.shape[1]:
        raise ValueError(f"key_bits {key_bits} past the table's {table.shape[1]} words")
    gtab, inv, dup = rows_fn(table, entries[1])
    gkeys, faults = keys_fn(keys, entries, inv, id_bits=id_bits)
    return gtab, gkeys, torch.cat([dup, faults])


def merge_packed(table, keys, entries, *, key_bits: int, id_bits: int):
    """The merge of N keyed entries on the tensors' device.

    table: (T, w) uint32, the entries' tables concatenated; keys: (n,)
    int64, their key runs concatenated; entries: (2, N+1) int64 as
    merge_keys takes it; key_bits: 2k (the rows compare whole: the bits
    below key_bits are zero). -> (the global table (T, w) uint32, the keys
    with global ids in position order, faults (3,) int64: duplicate
    k-mers, ids 0, ids past their table; the caller raises on any)."""
    return _merge(table, keys, entries, key_bits, id_bits, merge_rows, merge_keys)


def merge_packed_plain(table, keys, entries, *, key_bits: int, id_bits: int):
    """merge_packed through the plain versions (any device)."""
    return _merge(table, keys, entries, key_bits, id_bits, merge_rows_plain, merge_keys_plain)
