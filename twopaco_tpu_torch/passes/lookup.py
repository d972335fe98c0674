"""Bloom lookup: the junction ids of a window batch's candidate positions
(pass 4 of the Bloom engine).

The port of twopaco_tpu/passes/kernels.py:506 pass4_lookup. CUDA tensors
go through kernels/csrc/bloom_lookup.cu; CPU tensors through
`pass4_lookup_plain`, which runs the JAX package's fixed-step lower bound
in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import mark, records

INVALID_ID32 = (1 << 31) - 1  # the id of the unused output slots


def _outputs(cap: int, m: int, device):
    return (
        torch.full((cap,), m, dtype=torch.int32, device=device),
        torch.full((cap,), INVALID_ID32, dtype=torch.int32, device=device),
    )


def pass4_lookup_plain(packed, nmask, valid, mask, table, cap: int, *, k: int, P: int):
    """Plain PyTorch version of pass4_lookup (any device)."""
    B = packed.shape[0]
    out_pos, out_ids = _outputs(cap, B * P, packed.device)
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


def pass4_lookup(packed, nmask, valid, mask, table, cap: int, *, k: int, P: int):
    """Junction ids of one batch's candidate positions.

    packed, nmask, valid: the batch's upload form; mask (B, P/8) uint8: the
    OR of every round's candidate mask of the batch; table (J, w) uint32:
    the sorted junction dictionary; cap: the output length (at least the
    batch's candidate count).

    A candidate (mask bit set, inside the row's valid count, no N in its
    window) whose canonical k-mer is row r of the table gets id r+1, or
    -(r+1) when its reverse complement is the canonical strand.
    -> (pos (cap,) int32 batch-local flat positions row*P + col of the hits
    in ascending order, ids (cap,) int32, count: a 0-d int64 tensor, the
    number of hits). Slots past count hold B*P and INVALID_ID32.
    """
    if build.on_cpu(packed, nmask, valid, mask, table):
        return pass4_lookup_plain(packed, nmask, valid, mask, table, cap, k=k, P=P)
    B = packed.shape[0]
    w = pack.n_words(k)
    build.require(packed, torch.uint32, "packed")
    build.require(nmask, torch.uint32, "nmask")
    build.require(valid, torch.int32, "valid")
    build.require(mask, torch.uint8, "mask")
    build.require(table, torch.uint32, "table")
    J = table.shape[0]
    if (mask.shape != (B, P // 8) or P % 8 or table.shape != (J, w)
            or valid.shape != (B,) or packed.shape[1] * 16 < P + k + 1
            or nmask.shape[1] * 32 < P + k + 1):
        raise ValueError("pass4_lookup: batch, mask or table shapes disagree")
    n = B * P
    if n >= 1 << 31 or J >= (1 << 31) - 1:
        raise ValueError(f"{n} positions or {J} junctions exceed the int32 outputs")
    dev = packed.device
    out_pos, out_ids = _outputs(cap, n, dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if J == 0:  # nothing to find
        return out_pos, out_ids, count
    lib = build.lib()

    def i32(m):
        return torch.empty(m, dtype=torch.int32, device=dev)

    flags, incl_a, incl_b, cand_rc, cand_pos, ids = (i32(n) for _ in range(6))
    keys = i32(n * w)
    scratch = i32(lib.tp_scan_scratch_words(n))
    rc = lib.tp_bloom_lookup(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), B, P, k,
        packed.shape[1], nmask.shape[1], mask.data_ptr(), table.data_ptr(), J, cap,
        *(t.data_ptr() for t in (out_pos, out_ids, count, flags, incl_a, incl_b,
                                 cand_rc, cand_pos, ids, keys, scratch)),
        build.stream_ptr(),
    )
    build.check(rc, "bloom_lookup")
    build.count_launch("bloom_lookup")
    return out_pos, out_ids, count
