"""Round sort: records ordered by their w k-mer words.

The port of twopaco_tpu/passes/sortpipe.py:365 sort_records. CUDA
tensors go through the stable LSD radix sort in kernels/csrc/sort.cu;
CPU tensors through `sort_records_plain`, a stable sort per word from
the last to the first. Both are stable, so on the same input they give
the same permutation (lax.sort is not stable: against the JAX package
only the key order and each key's multiset of (payload, pos) agree).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack


def sort_records_plain(words, payload, pos):
    """Plain PyTorch version of sort_records (any device)."""
    keys = pack.as_i64(words)
    idx = torch.arange(words.shape[0], device=words.device)
    for j in reversed(range(words.shape[1])):
        idx = idx[torch.sort(keys[idx, j], stable=True).indices]
    return pack.take_u32(words, idx), pack.take_u32(payload, idx), pos[idx]


def sort_records(words, payload, pos):
    """Sort records (words (m, w) uint32, payload (m,) uint32, pos (m,)
    int64) by their words, lexicographically and stably; all-ones
    sentinel rows sort last. -> (words, payload, pos) sorted."""
    if build.on_cpu(words, payload, pos):
        return sort_records_plain(words, payload, pos)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    build.require(pos, torch.int64, "pos")
    m, w = words.shape
    if payload.shape != (m,) or pos.shape != (m,):
        raise ValueError("payload and pos must have one entry per record")
    if m >= 1 << 32:
        raise ValueError(f"{m} records exceed the sort's u32 indices")
    lib = build.lib()
    dev = words.device
    n_counts = lib.tp_sort_count_words(m)

    def u32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    key, key_alt = (torch.empty(m, dtype=torch.int64, device=dev) for _ in "ab")
    idx, idx_alt, counts, incl = u32(m), u32(m), u32(n_counts), u32(n_counts)
    scratch = u32(lib.tp_scan_scratch_words(n_counts))
    out_w = torch.empty((m, w), dtype=torch.uint32, device=dev)
    out_pay = torch.empty(m, dtype=torch.uint32, device=dev)
    out_pos = torch.empty(m, dtype=torch.int64, device=dev)
    rc = lib.tp_sort_records(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), m, w,
        *(t.data_ptr() for t in (key, key_alt, idx, idx_alt, counts, incl,
                                 scratch, out_w, out_pay, out_pos)),
        build.stream_ptr(),
    )
    build.check(rc, "sort_records")
    build.count_launch("sort_records")
    return out_w, out_pay, out_pos
