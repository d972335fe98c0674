"""The device steps of the hash-sharded Bloom filter (the dist-bloom engine).

The port of twopaco_tpu/parallel/sharded.py:112 _bucket, :143 _local_fill,
:149 _local_probe and :155 _unbucket with the rest of :181 _mark_shard_fn.
CUDA tensors go through kernels/csrc/bloom_shard.cu; CPU tensors through
the plain version beside each wrapper, which follows _bucket and _unbucket
step for step over passes/fill.py fill_indices, passes/mark.py
mark_indices, mark_decide and pack_mask, and ops/bloom.py fill and probe.

A filter of 2^f global slots is sharded over D shards: global slot i lives
on shard i mod D at local slot i div D (parallel/sharded.py). Per batch a
shard buckets its rows' indices by owner into (D, cap) send slots
(bucket_fill, bucket_mark), the mesh exchanges them, and the owner sets
(fill_local) or reads (probe_local) the local slots it receives; the hits
go back along the same slots and mark_finish decides the candidates.

Indices and local slots are int64 tensors holding the JAX package's u64
bits: SENT (-1, all ones) is an empty send slot. A mark probe's send slot
(owner * cap + rank) is int32, -1 where the probe is not sent; a batch's
probe slots are (8q, B*P), edge-hash major (probe j of position t at [j,
t]), so the kernels write and read them coalesced.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.passes import fill, mark

SENT = -1
LAYOUTS = {"byte": fill.LAYOUTS["byte"], "bit": fill.LAYOUTS["bit"]}
# bloom_shard.cu's bucketing tile: 256 threads; TILE_MAX positions a tile,
# halved while its shared memory passes SMEM_TARGET (two blocks an SM),
# down to one; a tile over SMEM_MAX, or of 2^16 indices, is refused
THREADS = 256
TILE_MAX = 256
SMEM_TARGET, SMEM_MAX = 112 * 1024, 226 * 1024


def _tile_smem(tpos: int, per: int, n_shards: int, wide: bool) -> int:
    """Shared bytes of a tile (bloom_shard.cu geo_smem)."""
    items = -(-tpos * per // THREADS) * THREADS
    return (items * (2 * (8 if wide else 4) + 2) + tpos * 9 * 4 + (3 * n_shards + 1) * 4
            + (THREADS // 32) * n_shards * 2)


def tile_positions(n_shards: int, q: int, f: int, marking: bool) -> int:
    """Positions a tile of tp_shard_bucket (bloom_shard.cu plan_geo) for
    D shards, q hashes, f bits (f >= 32: u64 indices)."""
    per = (8 if marking else 4) * q
    tpos = TILE_MAX
    while tpos > 1 and _tile_smem(tpos, per, n_shards, f >= 32) > SMEM_TARGET:
        tpos //= 2
    return tpos


def tile_fits(n_shards: int, q: int, f: int, marking: bool) -> bool:
    """Whether that tile fits a block (plan_geo's answer): the kernel
    refuses the rest. Even a tile of one position does not fit past q =
    1,600 in mark mode at f >= 32 over 4 shards (800 over 4,096); fill
    mode and f < 32 allow up to 2 and 1.8 times more. The plain version
    takes any q."""
    per = (8 if marking else 4) * q
    tpos = tile_positions(n_shards, q, f, marking)
    return (_tile_smem(tpos, per, n_shards, f >= 32) <= SMEM_MAX
            and -(-tpos * per // THREADS) * THREADS < 1 << 16)


def scratch_bytes(n_pos: int, n_shards: int, q: int, f: int, marking: bool) -> int:
    """Device bytes of tp_shard_bucket's scratch for n_pos positions
    (tp_shard_scratch_bytes, which gives 0 where the tile does not fit):
    the tile counter (8 bytes) and the look-back status words (D u64 a
    tile)."""
    tiles = max(1, -(-n_pos // tile_positions(n_shards, q, f, marking)))
    return 8 + tiles * n_shards * 8


def _counter(counter, dev) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int64, device=dev) if counter is None else counter


def bucket_indices_plain(idx, valid, n_shards: int, cap: int, overflow=None):
    """sharded.py:112 _bucket on flat global indices idx (M,) int64 where
    valid (M,) -> (send (D, cap) int64 local slots, each owner's in index
    order, SENT past its count; probe slots (M,) int32; overflow: the valid
    indices past cap added to it)."""
    D = n_shards
    if D * cap >= 1 << 31:
        raise ValueError(f"{D} x {cap} send slots exceed the int32 probe slots")
    m = idx.numel()
    dev = idx.device
    owner = torch.where(valid, idx % D, D)
    order = torch.sort(owner, stable=True).indices
    o_s = owner[order]
    l_s = (idx // D)[order]
    counts = torch.bincount(o_s, minlength=D + 1)
    slot = torch.arange(m, device=dev) - (torch.cumsum(counts, 0) - counts)[o_s]
    live = o_s < D
    ok = live & (slot < cap)
    dst = (o_s * cap + slot)[ok]
    send = torch.full((D * cap,), SENT, dtype=torch.int64, device=dev)
    send[dst] = l_s[ok]
    probe_slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    probe_slot[order[ok]] = dst.to(torch.int32)
    overflow = _counter(overflow, dev)
    overflow += (live & (slot >= cap)).sum()
    return send.view(D, cap), probe_slot, overflow


def bucket_fill_plain(packed, nmask, valid, low: int, high: int, *, cfg, n_shards: int,
                      cap: int, overflow=None):
    """Plain PyTorch version of bucket_fill (any device)."""
    idx, val = fill.fill_indices(fill.batch_codes(packed, nmask, cfg), valid, low, high, cfg)
    send, _slots, overflow = bucket_indices_plain(
        idx.reshape(-1), val.reshape(-1), n_shards, cap, overflow)
    return send, overflow


def bucket_mark_plain(packed, nmask, valid, low: int, high: int, *, cfg, n_shards: int,
                      cap: int, overflow=None):
    """Plain PyTorch version of bucket_mark (any device)."""
    idx, base, _prev, _nxt = mark.mark_indices(
        fill.batch_codes(packed, nmask, cfg), valid, low, high, cfg)
    probe_valid = base[:, :, None, None].expand(idx.shape)
    send, slots, overflow = bucket_indices_plain(idx.reshape(-1), probe_valid.reshape(-1),
                                                 n_shards, cap, overflow)
    return send, slots.view(-1, 8 * cfg.q).t().contiguous(), overflow


def _check_shards(cfg, n_shards: int, cap: int, n: int) -> None:
    if cfg.layout not in LAYOUTS:
        raise ValueError(f"the sharded filter has the byte or bit layout, not {cfg.layout!r}")
    if not 1 <= n_shards <= build.lib().tp_route_max_shards() or cap < 1:
        raise ValueError(f"{n_shards} shards or cap {cap} outside the kernel's range")
    if n >= 1 << 32 or n_shards * cap >= 1 << 31:
        raise ValueError("indices or send slots exceed the bucketing's u32 ranks "
                         "and int32 probe slots")
    if not 1 <= cfg.f <= 63:
        raise ValueError(f"f = {cfg.f}: the indices are at most 63 bits")


def _bucket(packed, nmask, valid, low, high, cfg, n_shards, cap, overflow, marking: bool):
    fill.check_upload(packed, nmask, valid, cfg)
    B = packed.shape[0]
    n = B * cfg.P * (8 if marking else 4) * cfg.q
    _check_shards(cfg, n_shards, cap, n)
    dev = packed.device
    overflow = _counter(overflow, dev)
    build.require(overflow, torch.int64, "overflow")
    if overflow.device != dev:
        raise ValueError(f"overflow on {overflow.device}, batch on {dev}")
    if not tile_fits(n_shards, cfg.q, cfg.f, marking):
        raise ValueError(f"q = {cfg.q} over {n_shards} shards: one position's indices exceed "
                         "a bucketing block's shared memory")
    scratch, epoch = build.lookback_scratch(
        dev, scratch_bytes(B * cfg.P, n_shards, cfg.q, cfg.f, marking))
    send = torch.empty((n_shards, cap), dtype=torch.int64, device=dev)
    probe_slot = (torch.empty((8 * cfg.q, B * cfg.P), dtype=torch.int32, device=dev)
                  if marking else None)
    rc = build.lib().tp_shard_bucket(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), B, cfg.P, cfg.k,
        packed.shape[1], nmask.shape[1], int(low), int(high),
        build.hash_tables(fill.ALL_TABLES), cfg.q, cfg.f, int(marking), n_shards, cap,
        scratch.data_ptr(), scratch.numel(), epoch, send.data_ptr(),
        probe_slot.data_ptr() if marking else None, overflow.data_ptr(), build.stream_ptr(),
    )
    if rc != 0:
        build.drop_lookback_scratch(dev)
    build.check(rc, "shard_bucket")
    build.count_launch("shard_bucket_mark" if marking else "shard_bucket_fill")
    return send, probe_slot, overflow


def bucket_fill(packed, nmask, valid, low: int, high: int, *, cfg, n_shards: int, cap: int,
                overflow=None):
    """The fill indices of one batch bucketed by owner shard.

    packed, nmask, valid: the upload form of a shard's B/D rows of a batch
    (as fill.bloom_fill's); [low, high]: the round's inclusive vertex-hash
    interval; cfg: the PassConfig (k, q, f, byte or bit layout, P).
    -> (send (n_shards, cap) int64: owner d's local slots (index div D) of
    the indices it owns (index mod D), in the flat (row, position, edge,
    hash) order of fill.fill_indices, SENT past its count; overflow, the
    (1,) int64 count of indices past cap, added to (a new one when None)).
    On the card a q whose one position's indices overflow the kernel's
    block (tile_fits: past 1,600 in mark mode at f >= 32 over 4 shards)
    raises ValueError; the plain version takes any q."""
    if build.on_cpu(packed, nmask, valid, *(() if overflow is None else (overflow,))):
        return bucket_fill_plain(packed, nmask, valid, low, high, cfg=cfg, n_shards=n_shards,
                                 cap=cap, overflow=overflow)
    send, _slots, overflow = _bucket(packed, nmask, valid, low, high, cfg, n_shards, cap,
                                     overflow, marking=False)
    return send, overflow


def bucket_mark(packed, nmask, valid, low: int, high: int, *, cfg, n_shards: int, cap: int,
                overflow=None):
    """The mark probes of one batch bucketed by owner shard: the 8q probes
    of mark.mark_indices of every position in the round (a record, vertex
    hash in [low, high]). Arguments as bucket_fill's.
    -> (send (n_shards, cap) int64, probe slots (8*q, B*P) int32: probe j
    of position t's owner * cap + rank at [j, t], -1 where it is not sent;
    overflow)."""
    if build.on_cpu(packed, nmask, valid, *(() if overflow is None else (overflow,))):
        return bucket_mark_plain(packed, nmask, valid, low, high, cfg=cfg, n_shards=n_shards,
                                 cap=cap, overflow=overflow)
    return _bucket(packed, nmask, valid, low, high, cfg, n_shards, cap, overflow, marking=True)


def fill_local_plain(filt, recv, layout: str):
    """Plain PyTorch version of fill_local (any device)."""
    recv = recv.reshape(-1)
    v = recv != SENT
    return bloom.fill(filt, torch.where(v, recv, 0), v, layout)


def probe_local_plain(filt, recv, layout: str):
    """Plain PyTorch version of probe_local (any device)."""
    recv = recv.reshape(-1)
    v = recv != SENT
    return (bloom.probe(filt, torch.where(v, recv, 0), layout) & v).to(torch.uint8)


def _check_local(filt, recv, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"the sharded filter has the byte or bit layout, not {layout!r}")
    build.require(filt, torch.uint8 if layout == "byte" else torch.uint32, "filter shard")
    build.require(recv, torch.int64, "received slots")


def _check_block(recv) -> None:
    if recv.dim() != 2:
        raise ValueError(f"received slots: expected a (D, cap) block, got {tuple(recv.shape)}")


def fill_local(filt, recv, layout: str):
    """Set the received local slots of this shard's filter filt (the byte
    or bit layout of a shard of parallel/sharded.py make_sharded_filter),
    in place. -> filt.

    recv: the (D, cap) int64 block the exchange delivered, row d from
    shard d. Each row is a prefix of sent local slots followed by SENT, as
    bucket_fill (bloom_shard.cu's tp_shard_bucket, JAX's _bucket) writes every
    owner's row; the kernel reads each row only up to its first SENT."""
    _check_block(recv)
    if build.on_cpu(filt, recv):
        return fill_local_plain(filt, recv, layout)
    _check_local(filt, recv, layout)
    rc = build.lib().tp_shard_fill_apply(recv.data_ptr(), recv.shape[0], recv.shape[1],
                                         LAYOUTS[layout], filt.data_ptr(), build.stream_ptr())
    build.check(rc, "shard_fill_apply")
    build.count_launch("shard_fill")
    return filt


def probe_local(filt, recv, layout: str):
    """The received local slots read in this shard's filter: -> hits
    (recv.numel(),) uint8, 1 where the slot is set (SENT: 0).

    recv: the (D, cap) int64 block the exchange delivered, each row a
    prefix of sent slots followed by SENT (as fill_local's); the kernel
    reads each row only up to its first SENT and writes the rest as 0."""
    _check_block(recv)
    if build.on_cpu(filt, recv):
        return probe_local_plain(filt, recv, layout)
    _check_local(filt, recv, layout)
    hits = torch.empty(recv.numel(), dtype=torch.uint8, device=recv.device)
    rc = build.lib().tp_shard_probe(recv.data_ptr(), recv.shape[0], recv.shape[1],
                                    LAYOUTS[layout], filt.data_ptr(), hits.data_ptr(),
                                    build.stream_ptr())
    build.check(rc, "shard_probe")
    build.count_launch("shard_probe")
    return hits


def mark_finish_plain(back, probe_slot, packed, nmask, valid, low: int, high: int, *, cfg,
                      count=None):
    """Plain PyTorch version of mark_finish (any device)."""
    codes = fill.batch_codes(packed, nmask, cfg)
    _hfhr, _hv, base, prev, nxt = mark.mark_common(codes, valid, low, high, cfg,
                                                   fill.ALL_TABLES[:1])
    sent = probe_slot >= 0
    got = back.reshape(-1)[probe_slot.clamp(min=0).to(torch.int64)] > 0
    hits = (got & sent).t().reshape(*base.shape, 8, cfg.q).all(dim=-1)
    cand = mark.mark_decide(hits, base, prev, nxt)
    count = _counter(count, cand.device)
    count += cand.sum()
    return mark.pack_mask(cand), count


def mark_finish(back, probe_slot, packed, nmask, valid, low: int, high: int, *, cfg,
                count=None):
    """The candidate mask of a batch from the hits sent back.

    back (D*cap,) uint8: the hits of this shard's probes, block d from
    shard d, at the send slots of bucket_mark; probe_slot: bucket_mark's;
    the batch, round and cfg as bucket_mark's. Each probe reads its hit
    through its send slot (not sent: a miss), the q probes of an edge are
    ANDed, and mark.mark_decide decides each position.
    -> (mask (B, P/8) uint8, MSB first; count, the (1,) int64 number of
    candidates, added to (a new one when None)).

    On the card one launch."""
    extra = (back, probe_slot) + (() if count is None else (count,))
    if build.on_cpu(packed, nmask, valid, *extra):
        return mark_finish_plain(back, probe_slot, packed, nmask, valid, low, high, cfg=cfg,
                                 count=count)
    fill.check_upload(packed, nmask, valid, cfg)
    B = packed.shape[0]
    build.require(back, torch.uint8, "back")
    build.require(probe_slot, torch.int32, "probe_slot")
    if probe_slot.shape != (8 * cfg.q, B * cfg.P):
        raise ValueError(f"probe_slot: expected ({8 * cfg.q}, {B * cfg.P}), "
                         f"got {tuple(probe_slot.shape)}")
    count = _counter(count, packed.device)
    build.require(count, torch.int64, "count")
    out = torch.empty((B, cfg.P // 8), dtype=torch.uint8, device=packed.device)
    rc = build.lib().tp_shard_mark_finish(
        back.data_ptr(), probe_slot.data_ptr(), packed.data_ptr(), nmask.data_ptr(),
        valid.data_ptr(), B, cfg.P, cfg.k, packed.shape[1], nmask.shape[1], int(low),
        int(high), build.hash_tables(fill.ALL_TABLES), cfg.q, out.data_ptr(),
        count.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "shard_mark_finish")
    build.count_launch("shard_mark_finish")
    return out, count
