"""Resident rounds: records split once into per-round blocks, then each
round gathered into its sort buffer.

The port of twopaco_tpu/passes/sortpipe.py:166 build_and_partition,
:306 _partition_scan and :237 assemble_round. CUDA tensors go through
kernels/csrc/partition.cu (one launch and a tail over a device table of
batches: `partition_scan` over a pass's batches, `partition_batch` over a
one-row table) and assemble.cu; CPU tensors through the `*_plain`
versions.

A batch's records are built once per run (or once per group of rounds)
and split by round into fixed-cap blocks (nb, n_parts, part_cap): each
slot holds the w canonical words, the payload with the real bit, and the
u32 in-batch offset (16 bytes a slot at w = 2). A round's sort buffer is
then its blocks of every batch, with the flat position rebuilt as
row0 * P + offset.
"""

from __future__ import annotations

import numpy as np
import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes import records

# bytes of look-back status words (batches x tiles x rounds x 8) that one
# kernel call may use: a pass whose batches need more is split into calls
STATUS_BUDGET = 64 << 20


def _empty_blocks(shape, w: int, device):
    """Uninitialised (words shape + (w,) uint32, payload shape uint32,
    offset shape uint32, counts shape[:-1] int32): the kernel writes every
    slot."""
    return (
        torch.empty((*shape, w), dtype=torch.uint32, device=device),
        torch.empty(shape, dtype=torch.uint32, device=device),
        torch.empty(shape, dtype=torch.uint32, device=device),
        torch.empty(shape[:-1], dtype=torch.int32, device=device),
    )


def _highs_tensor(highs, dev) -> torch.Tensor:
    """The rounds' bounds (host integers) as a uint32 tensor on dev,
    converted on the host: the copy is the only device work."""
    return pack.as_u32(torch.as_tensor(np.asarray(highs, np.int64))).view(torch.int32).to(
        dev).view(torch.uint32)


def partition_batch_plain(
    packed, nmask, valid, highs, low: int, high: int, *, k: int, P: int,
    part_cap: int, out=None,
):
    """Plain PyTorch version of partition_batch (any device)."""
    canon, payload, hv, ok = records.batch_records_plain(packed, nmask, valid, k=k, P=P)
    n_parts = highs.shape[0]
    dev = canon.device
    ok = ok & (hv >= low) & (hv <= high)
    part = torch.searchsorted(pack.as_i64(highs), hv, side="left")
    part = torch.where(ok, part, n_parts)
    order = torch.sort(part, stable=True).indices  # in-batch order per round
    ps = part[order]
    n_all = torch.bincount(part, minlength=n_parts + 1)
    starts = torch.cumsum(n_all, 0) - n_all
    rank = torch.arange(len(ps), device=dev) - starts[ps]
    keep = (ps < n_parts) & (rank < part_cap)
    src, dp, dr = order[keep], ps[keep], rank[keep]
    blk_w = torch.full((n_parts, part_cap, canon.shape[1]), MASK32, dtype=torch.int64, device=dev)
    blk_pay = torch.zeros((n_parts, part_cap), dtype=torch.int64, device=dev)
    blk_off = torch.zeros((n_parts, part_cap), dtype=torch.int64, device=dev)
    blk_w[dp, dr] = canon[src]
    blk_pay[dp, dr] = payload[src] | records.REAL
    blk_off[dp, dr] = src
    res = (
        pack.as_u32(blk_w), pack.as_u32(blk_pay), pack.as_u32(blk_off),
        n_all[:n_parts].to(torch.int32),
    )
    if out is None:
        return res
    for dst, s in zip(out, res):
        dst.view(torch.int32).copy_(s.view(torch.int32))
    return out


def _partition(uploads, highs, low: int, high: int, k: int, P: int, part_cap: int, out):
    """The kernel over the batches into out (words (nb, n_parts, part_cap,
    w), payload, offset (nb, n_parts, part_cap), counts (nb, n_parts)), as
    few calls as STATUS_BUDGET allows, each one launch and a tail."""
    build.require(highs, torch.uint32, "highs")
    lib = build.lib()
    n_parts, nb, w = highs.shape[0], len(uploads), pack.n_words(k)
    if not 1 <= n_parts <= lib.tp_partition_max_parts():
        raise ValueError(
            f"{n_parts} rounds: the partition kernel takes 1 to "
            f"{lib.tp_partition_max_parts()}"
        )
    if n_parts * part_cap >= (1 << 32) - 1:
        raise ValueError(f"{n_parts} blocks of {part_cap} slots exceed the kernel's u32 slots")
    for packed, nmask, valid in uploads:
        records._check_batch(packed, nmask, valid, None, k, P)
    dev = uploads[0][0].device
    if highs.device != dev:
        raise ValueError(f"highs on {highs.device}, batches on {dev}")
    want = ((nb, n_parts, part_cap, w), (nb, n_parts, part_cap), (nb, n_parts, part_cap),
            (nb, n_parts))
    for t, shape, dt in zip(out, want, (torch.uint32,) * 3 + (torch.int32,)):
        build.require(t, dt, "out")
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"out: expected {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
    tile = lib.tp_partition_tile(k)
    tiles = -(-max(u[0].shape[0] for u in uploads) * P // tile)
    step = max(1, min(65535, (STATUS_BUDGET - 8) // (tiles * n_parts * 8)))
    for c0 in range(0, nb, step):
        chunk = uploads[c0 : c0 + step]
        max_pos = max(u[0].shape[0] for u in chunk) * P
        scratch, epoch = build.lookback_scratch(
            dev, 8 + len(chunk) * -(-max_pos // tile) * n_parts * 8, "partition")
        table = build.batch_table(chunk)
        rc = lib.tp_partition_records(
            table.data_ptr(), len(chunk), max_pos, P, k, int(low), int(high), *bz.TABLE_1,
            highs.data_ptr(), n_parts, part_cap, scratch.data_ptr(), scratch.numel(), epoch,
            *(t[c0].data_ptr() for t in out), build.stream_ptr(),
        )
        if rc != 0:
            build.drop_lookback_scratch(dev, "partition")
        build.check(rc, "partition")
        build.count_launch("partition")
    return out


def partition_batch(
    packed, nmask, valid, highs, low: int, high: int, *, k: int, P: int,
    part_cap: int, out=None,
):
    """Build one batch's records and split them by round.

    packed, nmask, valid: the batch's upload form (see
    records.build_sort_records). highs (n_parts,) uint32: non-decreasing
    inclusive upper bounds of the rounds' hash intervals; a record goes to
    the first round whose bound is at or above its vertex hash. Positions
    without a record, or whose hash lies outside [low, high], are dropped.

    -> (words (n_parts, part_cap, w) uint32, payload (n_parts, part_cap)
    uint32 with the real bit, offset (n_parts, part_cap) uint32 in-batch
    index, counts (n_parts,) int32). Each round's records fill its block
    in in-batch order; slots past the count are sentinels (all-ones words,
    payload 0, offset 0). counts are the true counts: a count above
    part_cap means the block overflowed and the caller must re-split.
    out: optional preallocated tuple of the four outputs.

    On the card: the kernel's launch over a one-row table."""
    if build.on_cpu(packed, nmask, valid, highs):
        return partition_batch_plain(
            packed, nmask, valid, highs, low, high, k=k, P=P,
            part_cap=part_cap, out=out,
        )
    if out is None:
        out = _empty_blocks((highs.shape[0], part_cap), pack.n_words(k), packed.device)
    for t in out:
        build.require(t, t.dtype, "out")  # contiguous: a one-batch view of it
    _partition([(packed, nmask, valid)], highs, low, high, k, P, part_cap,
               tuple(t.unsqueeze(0) for t in out))
    return out


def partition_scan_plain(
    uploads, highs, low: int, high: int, *, k: int, P: int, part_cap: int,
):
    """Plain PyTorch version of partition_scan: partition_batch_plain into
    each batch's blocks (any device)."""
    dev = uploads[0][0].device
    highs_d = _highs_tensor(highs, dev)
    out = _empty_blocks((len(uploads), len(highs), part_cap), pack.n_words(k), dev)
    for b, (packed, nmask, valid) in enumerate(uploads):
        partition_batch_plain(packed, nmask, valid, highs_d, low, high, k=k, P=P,
                              part_cap=part_cap, out=tuple(t[b] for t in out))
    return (*out[:3], out[3].cpu().numpy().astype(np.int64))


def partition_scan(
    uploads, highs, low: int, high: int, *, k: int, P: int, part_cap: int,
):
    """partition_batch over every batch of the run (twopaco_tpu
    sortpipe.py:306 _partition_scan). uploads: [(packed, nmask, valid)]
    on one device; highs: the rounds' bounds as host integers.
    -> stacked (words (nb, n_parts, part_cap, w), payload, offset (nb,
    n_parts, part_cap), counts (nb, n_parts) numpy int64).

    On the card: one launch and a tail over a device table of the batches
    (several such calls when their look-back status would pass
    STATUS_BUDGET)."""
    if build.on_cpu(*(t for u in uploads for t in u)):
        return partition_scan_plain(uploads, highs, low, high, k=k, P=P, part_cap=part_cap)
    dev = uploads[0][0].device
    highs_d = _highs_tensor(highs, dev)
    out = _empty_blocks((len(uploads), len(highs), part_cap), pack.n_words(k), dev)
    _partition(uploads, highs_d, low, high, k, P, part_cap, out)
    return (*out[:3], out[3].cpu().numpy().astype(np.int64))


def assemble_round_plain(r: int, blk_w, blk_pay, blk_off, bases, buf_slots: int):
    """Plain PyTorch version of assemble_round (any device)."""
    nb, _n_parts, cap, w = blk_w.shape
    dev = blk_w.device
    words = torch.full((buf_slots, w), -1, dtype=torch.int32, device=dev)
    pay = torch.zeros(buf_slots, dtype=torch.int32, device=dev)
    pos = torch.zeros(buf_slots, dtype=torch.int64, device=dev)
    m = nb * cap
    words[:m] = blk_w[:, r].reshape(m, w).view(torch.int32)
    pay[:m] = blk_pay[:, r].reshape(m).view(torch.int32)
    pos[:m] = (bases[:, None] + pack.as_i64(blk_off[:, r])).reshape(m)
    return words.view(torch.uint32), pay.view(torch.uint32), pos


def assemble_round(r: int, blk_w, blk_pay, blk_off, bases, buf_slots: int):
    """Round r's sort buffer from the stacked blocks of partition_scan.

    bases (nb,) int64: each batch's flat position base, row0 * P.
    -> (words (buf_slots, w) uint32, payload (buf_slots,) uint32, pos
    (buf_slots,) int64): row b*cap + j is slot j of batch b's block r with
    pos = bases[b] + offset; rows past nb*cap are sentinels (all-ones
    words, payload 0, pos 0).
    """
    if build.on_cpu(blk_w, blk_pay, blk_off, bases):
        return assemble_round_plain(r, blk_w, blk_pay, blk_off, bases, buf_slots)
    for t, dt, name in ((blk_w, torch.uint32, "words"), (blk_pay, torch.uint32, "payload"),
                        (blk_off, torch.uint32, "offset"), (bases, torch.int64, "bases")):
        build.require(t, dt, name)
    nb, n_parts, cap, w = blk_w.shape
    if (blk_pay.shape != (nb, n_parts, cap) or blk_off.shape != blk_pay.shape
            or bases.shape != (nb,) or not 0 <= r < n_parts or buf_slots < nb * cap):
        raise ValueError("assemble_round: block, base or buffer shapes disagree")
    dev = blk_w.device
    words = torch.empty((buf_slots, w), dtype=torch.uint32, device=dev)
    pay = torch.empty(buf_slots, dtype=torch.uint32, device=dev)
    pos = torch.empty(buf_slots, dtype=torch.int64, device=dev)
    rc = build.lib().tp_assemble_round(
        blk_w.data_ptr(), blk_pay.data_ptr(), blk_off.data_ptr(), bases.data_ptr(),
        nb, n_parts, cap, w, r, buf_slots, words.data_ptr(), pay.data_ptr(),
        pos.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "assemble_round")
    build.count_launch("assemble")
    return words, pay, pos
