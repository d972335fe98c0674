"""Bloom lookup: the junction ids of the candidate positions of window
batches (pass 4 of the Bloom engine), as the u64 occurrence keys that the
emit takes.

The port of twopaco_tpu/passes/kernels.py:506 pass4_lookup. A hit comes
out as key = pos << id_bits | (id + 2^(id_bits-1)), pos its global
position: the layout of passes/occ.py, which passes/emit.py checks and
writes where the keys lie. CUDA tensors go through
kernels/csrc/bloom_lookup.cu, one launch and a tail a call:
`pass4_lookup_batches` over a run's (or a group's) batches, `pass4_lookup`
for one batch (a one-row table). CPU tensors go through
`pass4_lookup_plain`, which runs the JAX package's fixed-step lower bound
in plain PyTorch and returns its (positions, ids), and its per-batch loop
`pass4_lookup_batches_plain`, which packs them into keys.
"""

from __future__ import annotations

import math

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import mark, records

INVALID_ID32 = (1 << 31) - 1  # pass4_lookup_plain's id of the unused output slots
PAD_KEY = -1  # the key of the unused output slots: u64 max, past every key


def pass4_lookup_plain(packed, nmask, valid, mask, table, cap: int, *, k: int, P: int):
    """The JAX package's pass4_lookup in plain PyTorch (any device): one
    batch's hits as (pos (cap,) int32 batch-local flat positions row*P +
    col, ascending; ids (cap,) int32; count: a 0-d int64 tensor, the
    number of hits). Slots past count hold B*P and INVALID_ID32.
    pass4_lookup_batches_plain packs its hits into keys."""
    B = packed.shape[0]
    out_pos = torch.full((cap,), B * P, dtype=torch.int32, device=packed.device)
    out_ids = torch.full((cap,), INVALID_ID32, dtype=torch.int32, device=packed.device)
    J = table.shape[0]
    if J == 0:
        return out_pos, out_ids, torch.zeros((), dtype=torch.int64, device=packed.device)
    canon, payload, _hv, ok = records.batch_records_plain(packed, nmask, valid, k=k, P=P)
    cand = torch.nonzero(ok & mark.unpack_mask(mask, P).reshape(-1)).squeeze(1)
    keys = canon[cand]
    rc = ((payload[cand] >> 16) & 1) > 0
    tab = pack.as_i64(table)
    lo = torch.zeros(len(cand), dtype=torch.int64, device=packed.device)
    hi = torch.full_like(lo, J)
    for _ in range(max(1, math.ceil(math.log2(J + 1)))):
        mid = (lo + hi) >> 1
        right = pack.lex_less(tab[mid.clamp(max=J - 1)], keys) & (mid < hi)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    found = pack.lex_eq(tab[lo.clamp(max=J - 1)], keys) & (lo < J)
    ids = torch.where(rc, -(lo + 1), lo + 1)[found]
    pos = cand[found]
    n = min(len(pos), cap)
    out_pos[:n] = pos[:n].to(torch.int32)
    out_ids[:n] = ids[:n].to(torch.int32)
    return out_pos, out_ids, torch.tensor(len(pos), dtype=torch.int64, device=packed.device)


def _pad(uploads, bases, P: int) -> int:
    """The position past the last batch's."""
    return int(bases[-1]) + uploads[-1][0].shape[0] * P


def _keys(pos, ids, id_bits: int):
    return (pos << id_bits) | (ids.to(torch.int64) + (1 << (id_bits - 1)))


def pass4_lookup_batches_plain(uploads, masks, table, cap: int, bases, *, k: int, P: int,
                               id_bits: int):
    """Plain PyTorch version of pass4_lookup_batches: pass4_lookup_plain a
    batch, the hits offset by the batch's base, packed into keys and
    concatenated (any device)."""
    _check_batches(uploads, masks, bases)
    _check_layout(uploads, table, bases, P, id_bits)
    keys = []
    for (packed, nmask, valid), m, base in zip(uploads, masks, bases):
        p, i, c = pass4_lookup_plain(packed, nmask, valid, m, table, packed.shape[0] * P,
                                     k=k, P=P)
        c = int(c)
        keys.append(_keys(p[:c].to(torch.int64) + int(base), i[:c], id_bits))
    keys = torch.cat(keys)
    out = torch.full((cap,), PAD_KEY, dtype=torch.int64, device=keys.device)
    n = min(len(keys), cap)
    out[:n] = keys[:n]
    return out, torch.tensor(len(keys), dtype=torch.int64, device=keys.device)


def _check_batches(uploads, masks, bases) -> None:
    if not uploads or len(masks) != len(uploads) or len(bases) != len(uploads):
        raise ValueError(f"{len(uploads)} batches, {len(masks)} masks, {len(bases)} bases")


def _check_layout(uploads, table, bases, P: int, id_bits: int) -> None:
    """Every id of the table and every position of the batches fits the
    key layout."""
    if not 2 <= id_bits <= 62:
        raise ValueError(f"id_bits {id_bits} out of range")
    if table.shape[0] >= 1 << (id_bits - 1) or _pad(uploads, bases, P) > 1 << (64 - id_bits):
        raise ValueError(f"{table.shape[0]} junctions or {_pad(uploads, bases, P)} positions "
                         f"do not fit a key of {id_bits} id bits")


def _lookup(uploads, masks, table, cap: int, bases, k: int, P: int, id_bits: int):
    """The kernel's call over the batches: -> (keys, count)."""
    w = pack.n_words(k)
    build.require(table, torch.uint32, "table")
    J = table.shape[0]
    dev = uploads[0][0].device
    for (packed, nmask, valid), m in zip(uploads, masks):
        B = packed.shape[0]
        build.require(packed, torch.uint32, "packed")
        build.require(nmask, torch.uint32, "nmask")
        build.require(valid, torch.int32, "valid")
        build.require(m, torch.uint8, "mask")
        if (m.shape != (B, P // 8) or P % 8 or P < 8 or valid.shape != (B,)
                or packed.shape[1] * 16 < P + k + 1 or nmask.shape[1] * 32 < P + k + 1):
            raise ValueError("pass4_lookup: batch or mask shapes disagree")
    if table.shape != (J, w):
        raise ValueError(f"pass4_lookup: table {tuple(table.shape)} is not (J, {w})")
    max_pos = max(up[0].shape[0] for up in uploads) * P
    if len(uploads) * max_pos >= 1 << 31 or J >= (1 << 31) - 1:
        raise ValueError(f"{len(uploads) * max_pos} positions or {J} junctions exceed a "
                         "lookup call's int32 ranks and ids")
    _check_layout(uploads, table, bases, P, id_bits)
    if cap < 0:
        raise ValueError(f"cap {cap} < 0")
    out_keys = torch.empty(cap, dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    if J == 0:  # nothing to find
        return out_keys.fill_(PAD_KEY), count.zero_()
    lib = build.lib()
    base = min(m.data_ptr() for m in masks)
    tab, tab_bases = build.batch_table(uploads, [m.data_ptr() - base for m in masks],
                                       tail=[int(b) for b in bases])
    tiles = len(uploads) * max(1, -(-max_pos // lib.tp_lookup_tile()))
    scratch, epoch = build.lookback_scratch(dev, 8 + tiles * 8, "lookup")
    rc = lib.tp_bloom_lookup(
        tab.data_ptr(), tab_bases.data_ptr(), len(uploads),
        max_pos, P, k, base, table.data_ptr(), J, cap, id_bits,
        out_keys.data_ptr(), count.data_ptr(), scratch.data_ptr(),
        scratch.numel(), epoch, build.stream_ptr(),
    )
    if rc != 0:
        build.drop_lookback_scratch(dev, "lookup")
    build.check(rc, "bloom_lookup")
    build.count_launch("bloom_lookup")
    return out_keys, count


def pass4_lookup_batches(uploads, masks, table, cap: int, bases, *, k: int, P: int,
                         id_bits: int):
    """The candidate positions of a list of batches found in the junction
    dictionary, as occurrence keys, in one call.

    uploads: (packed, nmask, valid) batches on one device; masks: per batch
    its (B_b, P/8) uint8 mask, the OR of every round's candidate mask;
    table (J, w) uint32: the sorted junction dictionary; cap: the output
    length (at least the batches' candidate count); bases: each batch's
    first global position (batch order ascending: the keys are then
    ascending); id_bits: the keys' id bits (J < 2^(id_bits-1), every
    position below 2^(64-id_bits); ValueError otherwise).

    A candidate (mask bit set, inside the row's valid count, no N in its
    window) whose canonical k-mer is row r of the table gets id r+1, or
    -(r+1) when its reverse complement is the canonical strand.
    -> (keys (cap,) int64 holding the u64 keys pos << id_bits | (id +
    2^(id_bits-1)), pos the hit's global position base + row*P + col,
    batch by batch and ascending in each; count: a 0-d int64 tensor, the
    number of hits, which may exceed cap). Slots past count hold PAD_KEY.

    On the card one launch of the kernel and its tail over a device table
    of the batches."""
    if build.on_cpu(table, *(t for up in uploads for t in up), *masks):
        return pass4_lookup_batches_plain(uploads, masks, table, cap, bases, k=k, P=P,
                                          id_bits=id_bits)
    _check_batches(uploads, masks, bases)
    return _lookup(uploads, masks, table, cap, bases, k, P, id_bits)


def pass4_lookup(packed, nmask, valid, mask, table, cap: int, *, k: int, P: int,
                 id_bits: int):
    """One batch's candidate positions found in the junction dictionary,
    as occurrence keys of its batch-local flat positions row*P + col.

    packed, nmask, valid: the batch's upload form; mask (B, P/8) uint8: the
    OR of every round's candidate mask of the batch; table, cap, id_bits as
    pass4_lookup_batches'. -> (keys (cap,) int64, count), as
    pass4_lookup_batches' over this one batch at base 0.

    On the card: the kernel's call over a one-row table."""
    return pass4_lookup_batches([(packed, nmask, valid)], [mask], table, cap, [0], k=k, P=P,
                                id_bits=id_bits)
