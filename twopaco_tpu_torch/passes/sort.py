"""Round sort: records ordered by the k-mer bits of their w words.

The port of twopaco_tpu/passes/sortpipe.py:365 sort_records. CUDA
tensors go through the one-sweep stable LSD radix sort in
kernels/csrc/sort.cu; CPU tensors through `sort_records_plain`, a stable
sort per word from the last to the first. Both order by the leading
key_bits bits of the words only (callers pass 2k: a record's k-mer is
left-aligned and the bits below it are zero, sort.cu's header says why
the cut is exact) and both are stable, so on the same input they give the
same permutation (lax.sort is not stable: against the JAX package only
the key order and each key's multiset of (payload, pos) agree).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack

RADIX_BITS = 8
SORT_TILE = 3072  # records a tile of sort.cu's digit passes (256 threads x 12)
MAX_WORDS = 64  # sort.cu's pass plan holds 4 x 64 passes


def _word_bits(w: int, key_bits: int) -> list[int]:
    """The leading bits of each word that the sort reads (0: none)."""
    if not 1 <= w <= MAX_WORDS or not 1 <= key_bits <= 32 * w:
        raise ValueError(f"key_bits {key_bits} outside [1, {32 * w}] or w {w} outside "
                         f"[1, {MAX_WORDS}]")
    return [min(32, max(0, key_bits - 32 * j)) for j in range(w)]


def n_passes(w: int, key_bits: int) -> int:
    """The 8-bit digit passes sort.cu runs for records of w words sorted
    by their leading key_bits bits (one u64 key for w <= 2, else a group
    a word)."""
    if w <= 2:
        _word_bits(w, key_bits)
        return -(-key_bits // RADIX_BITS)
    return sum(-(-b // RADIX_BITS) for b in _word_bits(w, key_bits))


def scratch_bytes(n: int, passes: int) -> int:
    """Device bytes of sort.cu's scratch for n keys over `passes` digit
    passes (tp_sort_scratch_bytes): the look-back status array (256 u64 a
    tile), the histograms (256 u32 a pass) and the tile counters (one u32 a
    pass, rounded up to 8 bytes)."""
    tiles = -(-n // SORT_TILE)
    return tiles * 256 * 8 + passes * 256 * 4 + -(-passes * 4 // 8) * 8


def work_bytes(n: int, w: int) -> int:
    """Device bytes a sort of n records of w words takes beyond its inputs
    and outputs, at most: two u64 key buffers and two of what travels with
    the keys (w <= 2: u32 payload and u64 position; else a u32 index), and
    the scratch of the most passes records of w words can take (4w)."""
    return (16 + (24 if w <= 2 else 8)) * n + scratch_bytes(n, 4 * w)


def scratch(n: int, passes: int, dev) -> torch.Tensor:
    return torch.empty(scratch_bytes(n, passes), dtype=torch.uint8, device=dev)


def sort_records_plain(words, payload, pos, *, key_bits: int):
    """Plain PyTorch version of sort_records (any device)."""
    keys = pack.as_i64(words)
    idx = torch.arange(words.shape[0], device=words.device)
    for j, bits in reversed(list(enumerate(_word_bits(words.shape[1], key_bits)))):
        if bits:
            mask = ((1 << bits) - 1) << (32 - bits)
            idx = idx[torch.sort(keys[idx, j] & mask, stable=True).indices]
    return pack.take_u32(words, idx), pack.take_u32(payload, idx), pos[idx]


def sort_records(words, payload, pos, *, key_bits: int):
    """Sort records (words (m, w) uint32, payload (m,) uint32, pos (m,)
    int64) by the leading key_bits bits of their words (the k-mer's 2k),
    lexicographically and stably; the bits below are not compared, and
    all-ones sentinel rows sort last. -> (words, payload, pos) sorted."""
    if build.on_cpu(words, payload, pos):
        return sort_records_plain(words, payload, pos, key_bits=key_bits)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    build.require(pos, torch.int64, "pos")
    m, w = words.shape
    if payload.shape != (m,) or pos.shape != (m,):
        raise ValueError("payload and pos must have one entry per record")
    if m >= 1 << 32:
        raise ValueError(f"{m} records exceed the sort's u32 indices")
    passes = n_passes(w, key_bits)
    dev = words.device

    def empty(dtype):
        return torch.empty(m, dtype=dtype, device=dev)

    # the keys, and what travels with them (sort.cu): w <= 2 the payload
    # and position, else the permutation; two buffers each
    key, key_alt = empty(torch.int64), empty(torch.int64)
    va, va_alt = empty(torch.int32), empty(torch.int32)
    vb, vb_alt = (empty(torch.int64), empty(torch.int64)) if w <= 2 else (None, None)
    work = scratch(m, passes, dev)
    out_w = torch.empty((m, w), dtype=torch.uint32, device=dev)
    out_pay = torch.empty(m, dtype=torch.uint32, device=dev)
    out_pos = torch.empty(m, dtype=torch.int64, device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (key, key_alt, va, va_alt, vb, vb_alt, work)]
    rc = build.lib().tp_sort_records(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), m, w, key_bits, *ptrs,
        work.numel(), *(t.data_ptr() for t in (out_w, out_pay, out_pos)), build.stream_ptr(),
    )
    build.check(rc, "sort_records")
    build.count_launch("sort_records")
    return out_w, out_pay, out_pos
