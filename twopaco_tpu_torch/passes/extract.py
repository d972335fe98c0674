"""Bloom extract: the candidate records of marked window batches, appended
to the round's verify buffer.

The port of twopaco_tpu/passes/kernels.py:420 extract_records. CUDA
tensors go through kernels/csrc/bloom_extract.cu, one launch and a tail a
call: `extract_records_batches` over a round's batches,
`extract_records` for one batch (a one-row table). CPU tensors go through
`extract_records_plain` and its per-batch loop
`extract_records_batches_plain`.

The records have the sort engine's layout (passes/records.py): canonical
words, payload in | out<<8 | is_rc<<16 | 1<<17, and position, so the round
buffer goes straight through passes/sort.py and passes/judge.py: the
judge's junction table of the buffer is verify_records' (kernels.py:446).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import mark, records

# positions a kernel call may hold (its ranks are u32, its tile counts int32)
CALL_POSITIONS = (1 << 31) - 1


def new_buffer(slots: int, w: int, device):
    """(words, payload, pos) verify buffer of `slots` records and its
    append state (off, overflow) as two int64 on the device."""
    return (
        torch.empty((slots, w), dtype=torch.uint32, device=device),
        torch.empty(slots, dtype=torch.uint32, device=device),
        torch.empty(slots, dtype=torch.int64, device=device),
    ), torch.zeros(2, dtype=torch.int64, device=device)


def extract_records_plain(packed, nmask, mask, buf, state, pos_base: int, *, k: int, P: int):
    """Plain PyTorch version of extract_records (any device)."""
    codes = pack.unpack_codes(packed, nmask, P + k + 1).to(torch.int64)
    canon, payload = records.canonical_records_plain(codes, k=k, P=P)
    idx = torch.nonzero(mark.unpack_mask(mask, P).reshape(-1)).squeeze(1)
    buf_w, buf_pay, buf_pos = buf
    off = int(state[0])
    fit = idx[: max(0, min(len(idx), buf_pay.shape[0] - off))]
    if len(fit) < len(idx):
        state[1] = 1
    end = off + len(fit)
    buf_w[off:end].view(torch.int32).copy_(pack.as_u32(canon[fit]).view(torch.int32))
    buf_pay[off:end].view(torch.int32).copy_(
        pack.as_u32(payload[fit] | records.REAL).view(torch.int32)
    )
    buf_pos[off:end] = pos_base + fit
    state[0] = off + len(idx)
    return buf, state


def _check_batches(uploads, masks, bases) -> None:
    if not uploads or len(masks) != len(uploads) or len(bases) != len(uploads):
        raise ValueError(f"{len(uploads)} batches, {len(masks)} masks, {len(bases)} bases")


def extract_records_batches_plain(uploads, masks, buf, state, bases, *, k: int, P: int):
    """Plain PyTorch version of extract_records_batches: extract_records_plain
    a batch, in order (any device)."""
    _check_batches(uploads, masks, bases)
    for (packed, nmask, _valid), m, base in zip(uploads, masks, bases):
        extract_records_plain(packed, nmask, m, buf, state, int(base), k=k, P=P)
    return buf, state


def _extract(uploads, masks, buf, state, bases, k: int, P: int) -> None:
    """The kernel's calls over the batches: one, or one a group of batches
    when they pass CALL_POSITIONS."""
    buf_w, buf_pay, buf_pos = buf
    w = pack.n_words(k)
    for t, dt, name in ((buf_w, torch.uint32, "buffer words"),
                        (buf_pay, torch.uint32, "buffer payload"),
                        (buf_pos, torch.int64, "buffer pos"), (state, torch.int64, "state")):
        build.require(t, dt, name)
    S = buf_pay.shape[0]
    if buf_w.shape != (S, w) or buf_pos.shape != (S,) or state.shape != (2,) or P % 8 or P < 8:
        raise ValueError("extract_records: buffer, state or P disagree")
    for (packed, nmask, _valid), m in zip(uploads, masks):
        build.require(packed, torch.uint32, "packed")
        build.require(nmask, torch.uint32, "nmask")
        build.require(m, torch.uint8, "mask")
        if (m.shape != (packed.shape[0], P // 8) or packed.shape[1] * 16 < P + k + 1
                or nmask.shape[1] * 32 < P + k + 1):
            raise ValueError("extract_records: batch and mask shapes disagree")
    lib = build.lib()
    dev = buf_pay.device
    max_pos = max(up[0].shape[0] for up in uploads) * P
    if max_pos > CALL_POSITIONS:
        raise ValueError(f"a batch of {max_pos} positions exceeds an extract call's ranks")
    per = max(1, CALL_POSITIONS // max(max_pos, 1))
    for g0 in range(0, len(uploads), per):
        ups, ms = uploads[g0 : g0 + per], masks[g0 : g0 + per]
        base = min(m.data_ptr() for m in ms)
        tab, tab_bases = build.batch_table(ups, [m.data_ptr() - base for m in ms],
                                           tail=[int(b) for b in bases[g0 : g0 + per]])
        tiles = len(ups) * max(1, -(-max_pos // lib.tp_extract_tile()))
        scratch, epoch = build.lookback_scratch(dev, 8 + tiles * 8, "extract")
        rc = lib.tp_bloom_extract(
            tab.data_ptr(), tab_bases.data_ptr(), len(ups), max_pos, P, k, base,
            buf_w.data_ptr(), buf_pay.data_ptr(), buf_pos.data_ptr(), S, state.data_ptr(),
            scratch.data_ptr(), scratch.numel(), epoch, build.stream_ptr(),
        )
        if rc != 0:
            build.drop_lookback_scratch(dev, "extract")
        build.check(rc, "bloom_extract")
        build.count_launch("bloom_extract")


def extract_records_batches(uploads, masks, buf, state, bases, *, k: int, P: int):
    """Append the records of a list of batches' marked positions to the
    buffer, in one call.

    uploads: (packed, nmask, valid) batches on one device (valid is not
    read); masks: per batch its (B_b, P/8) uint8 mask from
    mark.bloom_mark_batches (views of one buffer, or any tensors); buf,
    state as extract_records'; bases: each batch's first global position.

    The marked positions' records, batch by batch and in flat order in
    each, go to rows off, off+1, ...; then off grows by their count.
    Records past row S are dropped and set the overflow flag. Nothing is
    read back to the host. -> (buf, state)

    On the card one launch of the kernel and its tail over a device table
    of the batches (one a group of batches past CALL_POSITIONS)."""
    if build.on_cpu(*buf, state, *(t for up in uploads for t in up[:2]), *masks):
        return extract_records_batches_plain(uploads, masks, buf, state, bases, k=k, P=P)
    _check_batches(uploads, masks, bases)
    _extract(uploads, masks, buf, state, bases, k, P)
    return buf, state


def extract_records(packed, nmask, mask, buf, state, pos_base: int, *, k: int, P: int):
    """Append the records of one batch's marked positions to the buffer.

    packed, nmask: the batch's upload form; mask (B, P/8) uint8 from
    mark.bloom_mark; buf = (words (S, w) uint32, payload (S,) uint32, pos
    (S,) int64) and state = int64 (off, overflow) from new_buffer; pos_base:
    the global flat position of the batch's first slot (row0 * P).

    The marked positions' records, in flat order, go to rows off, off+1,
    ...; then off grows by their count. Records past row S are dropped and
    set the overflow flag. Nothing is read back to the host. -> (buf, state)

    On the card: the kernel's call over a one-row table."""
    if build.on_cpu(packed, nmask, mask, *buf, state):
        return extract_records_plain(packed, nmask, mask, buf, state, pos_base, k=k, P=P)
    _extract([(packed, nmask, None)], [mask], buf, state, [pos_base], k, P)
    return buf, state
