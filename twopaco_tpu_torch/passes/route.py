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

import functools

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack


@functools.cache
def _limits() -> tuple[int, int]:
    """(shards a call may route to, records a look-back tile) of route.cu"""
    lib = build.lib()
    return lib.tp_route_max_shards(), lib.tp_route_tile()


def new_send(n_shards: int, cap: int, w: int, device):
    """Send buffers for route_records(out=...): words (D, cap, w) uint32,
    payload (D, cap) uint32, positions (D, cap) int64, uninitialised (a
    route writes every slot)."""
    return (
        torch.empty((n_shards, cap, w), dtype=torch.uint32, device=device),
        torch.empty((n_shards, cap), dtype=torch.uint32, device=device),
        torch.empty((n_shards, cap), dtype=torch.int64, device=device),
    )


def _check_out(out, n_shards: int, cap: int, w: int, device):
    """out, or new send buffers when None; raises on a wrong shape, type or
    device."""
    if out is None:
        return new_send(n_shards, cap, w, device)
    want = ((n_shards, cap, w), (n_shards, cap), (n_shards, cap))
    for t, shape, dtype, name in zip(out, want, (torch.uint32, torch.uint32, torch.int64),
                                     ("words", "payload", "pos")):
        build.require(t, dtype, f"out {name}")
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"out {name}: expected {shape} on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return out


def route_records_plain(words, payload, pos, n_shards: int, cap: int, bounds=None,
                        overflow=None, out=None):
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
    # all-ones words, payload 0, position 0 in every slot
    send_w, send_pay, send_pos = _check_out(out, D, cap, w, dev)
    send_w.view(torch.int32).fill_(-1)
    send_pay.view(torch.int32).zero_()
    send_pos.zero_()
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
                  overflow=None, out=None):
    """Bucket records by owner shard into (n_shards, cap) send slots.

    words (m, w) uint32, payload (m,) uint32, pos (m,) int64: records
    (real = payload bit 17). Owner of a real record: (word0 * D) >> 32
    without bounds, else the number of the (D - 1,) ascending uint32
    bounds strictly below word0 (searchsorted side='left'); records that
    are not real go nowhere. Each owner's slots hold its records in record
    order; the rest hold all-ones words, payload 0, position 0. Records
    past cap are dropped and added to overflow ((1,) int64 on the
    records' device, summed over calls; a new one when None). out: send
    buffers to write (new_send's), reused by a caller that routes many
    batches; new ones when None.

    -> (send words (D, cap, w) uint32, payload (D, cap) uint32, pos (D,
    cap) int64, overflow)
    """
    tensors = [words, payload, pos] + [t for t in (bounds, overflow) if t is not None]
    if build.on_cpu(*tensors, *(out or ())):
        return route_records_plain(words, payload, pos, n_shards, cap, bounds, overflow, out)
    build.require(words, torch.uint32, "words")
    build.require(payload, torch.uint32, "payload")
    build.require(pos, torch.int64, "pos")
    m, w = words.shape
    D = n_shards
    if payload.shape != (m,) or pos.shape != (m,):
        raise ValueError("payload and pos must have one entry per record")
    max_shards, tile = _limits()
    if not 1 <= D <= max_shards or cap < 1:
        raise ValueError(f"{D} shards or cap {cap} outside the kernel's range")
    if m >= 1 << 32 or D * cap >= (1 << 32) - 1:
        raise ValueError("records or send slots exceed the route's u32 ranks")
    if bounds is not None:
        build.require(bounds, torch.uint32, "bounds")
        if bounds.shape != (D - 1,):
            raise ValueError(f"bounds: expected ({D - 1},), got {tuple(bounds.shape)}")
    dev = words.device
    if overflow is None:
        overflow = torch.zeros(1, dtype=torch.int64, device=dev)
    build.require(overflow, torch.int64, "overflow")
    send_w, send_pay, send_pos = _check_out(out, D, cap, w, dev)
    scratch, epoch = build.lookback_scratch(dev, 8 + max(-(-m // tile), 1) * D * 8)
    rc = build.lib().tp_route_records(
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(), m, w, D,
        bounds.data_ptr() if bounds is not None else None, cap, scratch.data_ptr(),
        scratch.numel(), epoch, send_w.data_ptr(), send_pay.data_ptr(), send_pos.data_ptr(),
        overflow.data_ptr(), build.stream_ptr(),
    )
    if rc != 0:
        build.drop_lookback_scratch(dev)
    build.check(rc, "route_records")
    build.count_launch("route")
    return send_w, send_pay, send_pos, overflow
