"""Bloom extract: a marked batch's candidate records, appended to the
round's verify buffer.

The port of twopaco_tpu/passes/kernels.py:420 extract_records. CUDA
tensors go through kernels/csrc/bloom_extract.cu; CPU tensors through
`extract_records_plain`.

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


def extract_records(packed, nmask, mask, buf, state, pos_base: int, *, k: int, P: int):
    """Append the records of one batch's marked positions to the buffer.

    packed, nmask: the batch's upload form; mask (B, P/8) uint8 from
    mark.bloom_mark; buf = (words (S, w) uint32, payload (S,) uint32, pos
    (S,) int64) and state = int64 (off, overflow) from new_buffer; pos_base:
    the global flat position of the batch's first slot (row0 * P).

    The marked positions' records, in flat order, go to rows off, off+1,
    ...; then off grows by their count. Records past row S are dropped and
    set the overflow flag. Nothing is read back to the host. -> (buf, state)
    """
    buf_w, buf_pay, buf_pos = buf
    if build.on_cpu(packed, nmask, mask, buf_w, buf_pay, buf_pos, state):
        return extract_records_plain(packed, nmask, mask, buf, state, pos_base, k=k, P=P)
    B = packed.shape[0]
    w = pack.n_words(k)
    build.require(packed, torch.uint32, "packed")
    build.require(nmask, torch.uint32, "nmask")
    for t, dt, name in ((mask, torch.uint8, "mask"), (buf_w, torch.uint32, "buffer words"),
                        (buf_pay, torch.uint32, "buffer payload"),
                        (buf_pos, torch.int64, "buffer pos"), (state, torch.int64, "state")):
        build.require(t, dt, name)
    S = buf_pay.shape[0]
    if (mask.shape != (B, P // 8) or P % 8 or buf_w.shape != (S, w)
            or buf_pos.shape != (S,) or state.shape != (2,)
            or packed.shape[1] * 16 < P + k + 1 or nmask.shape[1] * 32 < P + k + 1):
        raise ValueError("extract_records: batch, mask, buffer or state shapes disagree")
    n = B * P
    if n >= 1 << 32:
        raise ValueError(f"{n} positions exceed the extraction's u32 scan")
    lib = build.lib()
    dev = packed.device
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    incl = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.tp_scan_scratch_words(n), dtype=torch.int32, device=dev)
    rc = lib.tp_bloom_extract(
        packed.data_ptr(), nmask.data_ptr(), B, P, k, packed.shape[1], nmask.shape[1],
        mask.data_ptr(), int(pos_base), buf_w.data_ptr(), buf_pay.data_ptr(),
        buf_pos.data_ptr(), S, state.data_ptr(), flags.data_ptr(), incl.data_ptr(),
        scratch.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "bloom_extract")
    build.count_launch("bloom_extract")
    return buf, state
