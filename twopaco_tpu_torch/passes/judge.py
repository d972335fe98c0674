"""Judge + compact: junction groups, rank ids, compacted outputs.

The port of twopaco_tpu/passes/sortpipe.py:453 judge_compact_fused and of
its semantic twin :375 judge_records (per record, no compaction: the
distributed step's judge). CUDA tensors go through kernels/csrc/judge.cu
(two launches a call, a kept look-back scratch of 172 bytes a tile of
2048 records); CPU tensors through `judge_compact_plain` and
`judge_records_plain`.

Over records sorted by k-mer words, a group is the run of equal words.
A group is a junction iff it is real (not the sentinel group) and has
more than one distinct in- or out-extension, counting ACGT extensions
as distinct symbols and every N extension as its own symbol (counters
clamped at 0x7FFF, ops/segments.py:132), and, when an abundance limit is
set, at most `abundance` records. Junction ids are 1-based ranks of the
junction groups in k-mer order, negated for records on the reverse
strand.

The judge also counts, in the copy that reads its counts back, the real
records and the most real records of one k-mer group: judge_compact,
given a dict `stats`, sets stats["records"] and stats["group_max"].
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack

NO_ABUNDANCE = (1 << 64) - 1  # the reference's default: no size check
_SAT = 0x7FFF


def _empty(w: int, device):
    return (
        torch.empty((0, w), dtype=torch.uint32, device=device),
        torch.empty(0, dtype=torch.int64, device=device),
        torch.empty(0, dtype=torch.int32, device=device),
        0, 0, 0,
    )


def _scratch(lib, m: int, dev):
    """(scratch, epoch) of a kernel call over m records: the judge's own
    look-back scratch, kept across calls, 172 bytes a tile of 2048 records
    (a flag, the tile's group segment and prefix, a rank)."""
    if m >= 1 << 31:
        raise ValueError(f"{m} records exceed the judge's u32 counts")
    return build.lookback_scratch(dev, lib.tp_judge_scratch_bytes(m), "judge")


def _check(rc: int, name: str, dev) -> None:
    if rc != 0:
        build.drop_lookback_scratch(dev, "judge")
    build.check(rc, name)


def _groups_plain(words, payload, abundance: int, stats: dict | None):
    """The group math of both judges, plain PyTorch: -> (ng group starts,
    gid group of each row, keep_g junction groups, grank 1-based rank of
    each junction group (0 elsewhere), greal real groups); fills `stats`
    where given."""
    m = words.shape[0]
    wd = pack.as_i64(words)
    p = pack.as_i64(payload)
    ng = torch.ones(m, dtype=torch.bool, device=words.device)
    ng[1:] = (wd[1:] != wd[:-1]).any(dim=-1)
    gid = torch.cumsum(ng.to(torch.int64), 0) - 1
    G = int(gid[-1]) + 1
    real = ((p >> 17) & 1) == 1
    rg = gid[real]
    in_c = (p & 0xFF)[real]
    out_c = ((p >> 8) & 0xFF)[real]

    def group_sum(x):
        return torch.zeros(G, dtype=torch.int64, device=words.device).index_add_(
            0, rg, x.to(torch.int64)
        )

    seen_in = sum((group_sum(in_c == c) > 0).to(torch.int64) for c in range(4))
    seen_out = sum((group_sum(out_c == c) > 0).to(torch.int64) for c in range(4))
    indeg = seen_in + group_sum(in_c == 4).clamp(max=_SAT)
    outdeg = seen_out + group_sum(out_c == 4).clamp(max=_SAT)
    greal = real[ng]  # a group's rows are all real or all sentinel
    keep_g = ((indeg > 1) | (outdeg > 1)) & greal
    size = group_sum(torch.ones_like(rg))
    if abundance < NO_ABUNDANCE:
        keep_g &= size <= min(abundance, (1 << 63) - 1)
    if stats is not None:
        stats["records"] = int(rg.numel())
        stats["group_max"] = int(size.max())
    grank = torch.cumsum(keep_g.to(torch.int64), 0) * keep_g
    return ng, gid, keep_g, grank, greal


def _signed_ids(payload, r):
    is_rc = ((pack.as_i64(payload) >> 16) & 1) == 1
    return torch.where(is_rc, -r, r)


def _read_counts(counts, stats: dict | None) -> list:
    """The kernel's five counts in one copy -> [n_groups, n_junc, n_occ];
    the real records and the largest group into `stats`."""
    n_groups, n_junc, n_occ, n_real, group_max = counts.tolist()
    if stats is not None:
        stats.update(records=n_real, group_max=group_max)
    return [n_groups, n_junc, n_occ]


def judge_compact_plain(words, payload, pos, abundance: int = NO_ABUNDANCE,
                        stats: dict | None = None):
    """Plain PyTorch version of judge_compact (any device)."""
    m, w = words.shape
    if m == 0:
        if stats is not None:
            stats.update(records=0, group_max=0)
        return _empty(w, words.device)
    ng, gid, keep_g, grank, greal = _groups_plain(words, payload, abundance, stats)
    first_rows = torch.nonzero(ng).squeeze(1)
    table = pack.take_u32(words, first_rows[keep_g])
    r = grank[gid]
    keep = r > 0
    occ_id = _signed_ids(payload, r)[keep].to(torch.int32)
    return (
        table, pos[keep], occ_id,
        int(greal.sum()), int(keep_g.sum()), int(keep.sum()),
    )


def judge_compact(words, payload, pos, abundance: int = NO_ABUNDANCE,
                  stats: dict | None = None):
    """Judge the sorted records of one round and compact the results.

    words (m, w) uint32 sorted, payload (m,) uint32, pos (m,) int64.
    -> (table (n_junc, w) uint32 junction k-mers in k-mer order,
        occ_pos (n_occ,) int64, occ_id (n_occ,) int32 = +-rank, in record
        order, n_groups (real k-mer groups), n_junc, n_occ)
    stats: a dict that gets "records" and "group_max" (module docstring).
    """
    if build.on_cpu(words, payload, pos):
        return judge_compact_plain(words, payload, pos, abundance, stats)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    build.require(pos, torch.int64, "pos")
    m, w = words.shape
    if payload.shape != (m,) or pos.shape != (m,):
        raise ValueError("payload and pos must have one entry per record")
    lib = build.lib()
    dev = words.device
    scratch, epoch = _scratch(lib, m, dev)
    table = torch.empty((m, w), dtype=torch.uint32, device=dev)
    occ_pos = torch.empty(m, dtype=torch.int64, device=dev)
    occ_id = torch.empty(m, dtype=torch.int32, device=dev)
    counts = torch.empty(5, dtype=torch.int64, device=dev)
    check_ab = abundance < NO_ABUNDANCE
    rc = lib.tp_judge_compact(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), m, w,
        int(check_ab), abundance if check_ab else 0, scratch.data_ptr(), scratch.numel(),
        epoch, *(t.data_ptr() for t in (table, occ_pos, occ_id, counts)),
        build.stream_ptr(),
    )
    _check(rc, "judge_compact", dev)
    build.count_launch("judge_compact")
    n_groups, n_junc, n_occ = _read_counts(counts, stats)
    return table[:n_junc], occ_pos[:n_occ], occ_id[:n_occ], n_groups, n_junc, n_occ


def judge_records_plain(words, payload, abundance: int = NO_ABUNDANCE):
    """Plain PyTorch version of judge_records (any device)."""
    m = words.shape[0]
    dev = words.device
    if m == 0:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return none, none, torch.zeros(0, dtype=torch.int32, device=dev), 0, 0, 0
    ng, gid, keep_g, grank, greal = _groups_plain(words, payload, abundance, None)
    r = grank[gid]
    keep = r > 0
    keep_first = ng & keep
    ids = _signed_ids(payload, r).to(torch.int32)
    return (
        keep_first, keep, ids,
        int(greal.sum()), int(keep_g.sum()), int(keep.sum()),
    )


def judge_records(words, payload, abundance: int = NO_ABUNDANCE):
    """Judge the sorted records of one shard, record by record
    (twopaco_tpu sortpipe.py:375 judge_records).

    words (m, w) uint32 sorted, payload (m,) uint32.
    -> (keep_first (m,) bool: the first row of a junction group, keep (m,)
        bool: a row of a junction group, ids (m,) int32 = +-rank of the
        row's junction group by strand (0 outside them), n_groups (real
        k-mer groups), n_junc, n_occ)
    """
    if build.on_cpu(words, payload):
        return judge_records_plain(words, payload, abundance)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    m, w = words.shape
    if payload.shape != (m,):
        raise ValueError("payload must have one entry per record")
    lib = build.lib()
    dev = words.device
    scratch, epoch = _scratch(lib, m, dev)
    keep_first = torch.empty(m, dtype=torch.bool, device=dev)
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    ids = torch.empty(m, dtype=torch.int32, device=dev)
    counts = torch.empty(5, dtype=torch.int64, device=dev)
    check_ab = abundance < NO_ABUNDANCE
    rc = lib.tp_judge_records(
        words.data_ptr(), payload.data_ptr(), m, w, int(check_ab),
        abundance if check_ab else 0, scratch.data_ptr(), scratch.numel(), epoch,
        *(t.data_ptr() for t in (keep_first, keep, ids, counts)),
        build.stream_ptr(),
    )
    _check(rc, "judge_records", dev)
    build.count_launch("judge_records")
    n_groups, n_junc, n_occ = _read_counts(counts, None)
    return keep_first, keep, ids, n_groups, n_junc, n_occ
