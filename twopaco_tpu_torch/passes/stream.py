"""Stream rounds: every round re-builds the records of every batch, gated
to its hash interval, and appends the in-round ones to its sort buffer.

The port of twopaco_tpu/passes/sortpipe.py:338 compact_batch_records and
:624 _stream_round_scan. CUDA tensors go through kernels/csrc/compact.cu;
CPU tensors through `compact_append_plain`. The mode for inputs whose
records exceed even the grouped budget: nothing but the upload stays on
the device between rounds (the reference re-streams its FASTA every
round the same way, vertexenumerator.h:228-392).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import records


def new_round_buffer(buf_slots: int, w: int, device):
    """(words all-ones, payload 0, pos 0) round buffer and its append
    state (off, overflow) as two int64 on the device."""
    return (
        torch.full((buf_slots, w), -1, dtype=torch.int32, device=device).view(torch.uint32),
        torch.zeros(buf_slots, dtype=torch.uint32, device=device),
        torch.zeros(buf_slots, dtype=torch.int64, device=device),
    ), torch.zeros(2, dtype=torch.int64, device=device)


def compact_append_plain(words, payload, pos, buf, state, lim: int):
    """Plain PyTorch version of compact_append (any device)."""
    real = (pack.as_i64(payload) >> 17) & 1
    order = torch.sort(1 - real, stable=True).indices  # real rows first
    cnt = int(real.sum())
    off = int(state[0])
    if off + cnt > lim:
        state[1] = 1
    off_c = min(off, lim)
    n = len(payload)
    buf_w, buf_pay, buf_pos = buf
    buf_w[off_c : off_c + n].view(torch.int32).copy_(words.view(torch.int32)[order])
    buf_pay[off_c : off_c + n].view(torch.int32).copy_(payload.view(torch.int32)[order])
    buf_pos[off_c : off_c + n] = pos[order]
    state[0] = off_c + cnt


def compact_append(words, payload, pos, buf, state, lim: int):
    """Append one batch's records to the round buffer.

    words (n, w) uint32, payload (n,) uint32, pos (n,) int64: the batch's
    records gated to the round (real bit set = in the round). buf: the
    round buffer (words (S, w), payload (S,), pos (S,)); state: int64 (off,
    overflow) on the buffer's device; lim = S - n.

    All n rows are written at min(off, lim), stably partitioned with the
    real rows first; then overflow |= off + cnt > lim and off = min(off,
    lim) + cnt (cnt = real rows). Nothing is read back to the host.

    On the card: two launches (compact.cu), over a look-back scratch kept
    across calls; n == 0 launches nothing.
    """
    buf_w, buf_pay, buf_pos = buf
    if build.on_cpu(words, payload, pos, buf_w, buf_pay, buf_pos, state):
        return compact_append_plain(words, payload, pos, buf, state, lim)
    for t, dt, name in ((words, torch.uint32, "words"), (payload, torch.uint32, "payload"),
                        (pos, torch.int64, "pos"), (buf_w, torch.uint32, "buffer words"),
                        (buf_pay, torch.uint32, "buffer payload"),
                        (buf_pos, torch.int64, "buffer pos"), (state, torch.int64, "state")):
        build.require(t, dt, name)
    n, w = words.shape
    S = buf_pay.shape[0]
    if (payload.shape != (n,) or pos.shape != (n,) or buf_w.shape != (S, w)
            or buf_pos.shape != (S,) or state.shape != (2,)):
        raise ValueError("compact_append: record, buffer or state shapes disagree")
    if not 0 <= lim <= S - n:
        raise ValueError(f"lim {lim} outside [0, {S - n}]")
    if n >= 1 << 32:
        raise ValueError(f"{n} records exceed the compaction's u32 ranks")
    if n == 0:
        return
    lib = build.lib()
    dev = words.device
    tiles = -(-n // lib.tp_compact_tile())
    scratch, epoch = build.lookback_scratch(dev, 16 + tiles * 8, "compact")
    rc = lib.tp_compact_append(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), n, w,
        buf_w.data_ptr(), buf_pay.data_ptr(), buf_pos.data_ptr(), int(lim),
        state.data_ptr(), scratch.data_ptr(), scratch.numel(), epoch, build.stream_ptr(),
    )
    if rc != 0:
        build.drop_lookback_scratch(dev, "compact")
    build.check(rc, "compact_append")
    build.count_launch("compact")


def stream_round(
    uploads, bases, low: int, high: int, *, k: int, P: int, buf_slots: int,
    build_fn=records.build_sort_records, compact_fn=compact_append,
):
    """One round's sort buffer from every batch (twopaco_tpu
    sortpipe.py:624 _stream_round_scan): build the batch's records gated
    to [low, high] and append the real ones.

    uploads: [(packed, nmask, valid)] on one device; bases: each batch's
    flat position base (row0 * P) as host integers.
    -> (words, payload, pos, overflow): overflow True means records past
    buf_slots - B*P were dropped and the round must not be used.
    """
    dev = uploads[0][0].device
    n = uploads[0][0].shape[0] * P
    w = pack.n_words(k)
    buf, state = new_round_buffer(buf_slots, w, dev)
    tmp = (
        torch.empty((n, w), dtype=torch.uint32, device=dev),
        torch.empty(n, dtype=torch.uint32, device=dev),
        torch.empty(n, dtype=torch.int64, device=dev),
    )
    for (packed, nmask, valid), base in zip(uploads, bases):
        build_fn(packed, nmask, valid, base, k=k, P=P, low=low, high=high, out=tmp)
        compact_fn(*tmp, buf, state, buf_slots - n)
    return (*buf, bool(state[1]))
