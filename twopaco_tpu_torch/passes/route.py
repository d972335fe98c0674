"""Record routing: one shard's records bucketed by the shard that owns
their k-mer range, into the send slots of the all_to_all exchange.

The port of twopaco_tpu/parallel/sortshard.py:52 _route_records. CUDA
tensors go through kernels/csrc/route.cu; CPU tensors through
`route_records_plain`.

Shard d owns a contiguous range of canonical word0 (the k-mer's first 16
chars), so every record of one k-mer lands on one shard and the shards'
sorted blocks concatenate, in shard order, into the global k-mer order.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack


def _empty_send(n_shards: int, cap: int, w: int, device):
    """All-ones words, payload 0, position 0 in every slot."""
    return (
        torch.full((n_shards, cap, w), -1, dtype=torch.int32, device=device).view(torch.uint32),
        torch.zeros((n_shards, cap), dtype=torch.uint32, device=device),
        torch.zeros((n_shards, cap), dtype=torch.int64, device=device),
    )


def route_records_plain(words, payload, pos, n_shards: int, cap: int, bounds=None,
                        overflow=None):
    """Plain PyTorch version of route_records (any device)."""
    D = n_shards
    m, w = words.shape
    dev = words.device
    real = ((pack.as_i64(payload) >> 17) & 1) == 1
    w0 = pack.as_i64(words[:, 0])
    if bounds is None:
        owner = (w0 * D) >> 32
    else:
        owner = torch.searchsorted(pack.as_i64(bounds), w0, side="left")
    owner = torch.where(real, owner, D)
    order = torch.sort(owner, stable=True).indices
    o_s = owner[order]
    counts = torch.bincount(o_s, minlength=D + 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(m, device=dev) - starts[o_s]
    live = o_s < D
    ok = live & (slot < cap)
    send_w, send_pay, send_pos = _empty_send(D, cap, w, dev)
    dst = (o_s * cap + slot)[ok]
    src = order[ok]
    send_w.view(torch.int32).view(D * cap, w)[dst] = words.view(torch.int32)[src]
    send_pay.view(torch.int32).view(-1)[dst] = payload.view(torch.int32)[src]
    send_pos.view(-1)[dst] = pos[src]
    if overflow is None:
        overflow = torch.zeros(1, dtype=torch.int64, device=dev)
    overflow += (live & (slot >= cap)).sum()
    return send_w, send_pay, send_pos, overflow


def route_records(words, payload, pos, n_shards: int, cap: int, bounds=None,
                  overflow=None):
    """Bucket records by owner shard into (n_shards, cap) send slots.

    words (m, w) uint32, payload (m,) uint32, pos (m,) int64: records
    (real = payload bit 17). Owner of a real record: (word0 * D) >> 32
    without bounds, else the number of the (D - 1,) ascending uint32
    bounds strictly below word0 (searchsorted side='left'); records that
    are not real go nowhere. Each owner's slots hold its records in record
    order; the rest hold all-ones words, payload 0, position 0. Records
    past cap are dropped and added to overflow ((1,) int64 on the
    records' device, summed over calls; a new one when None).

    -> (send words (D, cap, w) uint32, payload (D, cap) uint32, pos (D,
    cap) int64, overflow)
    """
    tensors = [words, payload, pos] + [t for t in (bounds, overflow) if t is not None]
    if build.on_cpu(*tensors):
        return route_records_plain(words, payload, pos, n_shards, cap, bounds, overflow)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    build.require(pos, torch.int64, "pos")
    m, w = words.shape
    D = n_shards
    if payload.shape != (m,) or pos.shape != (m,):
        raise ValueError("payload and pos must have one entry per record")
    lib = build.lib()
    if not 1 <= D <= lib.tp_route_max_shards() or cap < 1:
        raise ValueError(f"{D} shards or cap {cap} outside the kernel's range")
    if m >= 1 << 32 or D * cap >= 1 << 32:
        raise ValueError("records or send slots exceed the route's u32 ranks")
    if bounds is not None:
        build.require(bounds, torch.uint32, "bounds")
        if bounds.shape != (D - 1,):
            raise ValueError(f"bounds: expected ({D - 1},), got {tuple(bounds.shape)}")
    dev = words.device
    if overflow is None:
        overflow = torch.zeros(1, dtype=torch.int64, device=dev)
    build.require(overflow, torch.int64, "overflow")
    n_counts = lib.tp_route_count_words(m, D)

    def u32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    owner, counts, incl = u32(max(m, 1)), u32(n_counts), u32(n_counts)
    scratch = u32(lib.tp_scan_scratch_words(n_counts))
    send_w = torch.empty((D, cap, w), dtype=torch.uint32, device=dev)
    send_pay = torch.empty((D, cap), dtype=torch.uint32, device=dev)
    send_pos = torch.empty((D, cap), dtype=torch.int64, device=dev)
    rc = lib.tp_route_records(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), m, w, D,
        bounds.data_ptr() if bounds is not None else None, cap,
        *(t.data_ptr() for t in (owner, counts, incl, scratch, send_w, send_pay,
                                 send_pos, overflow)),
        build.stream_ptr(),
    )
    build.check(rc, "route_records")
    build.count_launch("route")
    return send_w, send_pay, send_pos, overflow
