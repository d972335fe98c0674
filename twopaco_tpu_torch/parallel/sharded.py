"""The hash-sharded Bloom filter over a mesh (parallel/mesh.py): the fill
and mark steps of the dist-bloom engine.

The port of twopaco_tpu/parallel/sharded.py. Rows are data-parallel (shard
s fills and marks the rows [s*B/D, (s+1)*B/D) of a batch) and the filter is
model-parallel: shard d owns the global slots i with i mod D == d, at local
slot i div D, so a filter of 2^f slots needs ceil(2^f / D) a shard (-f 36
over 4 shards: 2 GiB of bits each, where one device's bit layout stops at
2^35 slots). Every fill and probe is bucketed by owner, exchanged with one
mesh all_to_all, and applied to the owner's shard; probe hits come back
along the same slots. Capacities are fixed a batch and overflow is
counted, never dropped silently: a dropped fill would be a Bloom false
negative, which the algorithm cannot tolerate.

Each step is written once against the mesh interface, as
parallel/sortshard.py's; its device work is the Ops table's
(passes/shardbloom.py: the kernels' wrappers or their plain versions).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.parallel.mesh import on_device
from twopaco_tpu_torch.parallel.sortshard import KERNELS, Ops
from twopaco_tpu_torch.passes import shardbloom
from twopaco_tpu_torch.passes.pipeline import PassConfig


@dataclass(frozen=True)
class ShardedConfig:
    """Pass config and routing capacity for a mesh of n_shards
    (sharded.py:52): owner = index mod D, local slot = index div D."""

    base: PassConfig
    n_shards: int
    slack: float = 1.5

    def __post_init__(self):
        D = self.n_shards
        if (1 << self.base.f) < 32 * D:
            raise ValueError(
                f"a 2^{self.base.f}-slot filter cannot be sharded over {D} shards "
                "(each needs 32 slots at least)"
            )
        if self.base.B % D:
            raise ValueError(
                f"rows_per_batch ({self.base.B}) must be a multiple of the mesh size ({D})"
            )
        if self.base.layout == "block":
            raise ValueError(
                "the vertex-blocked layout is single-chip only; use "
                "--tpu-layout bit (or byte) with dist-bloom"
            )
        if self.base.layout not in ("byte", "bit"):
            raise ValueError(f"unknown Bloom layout {self.base.layout!r}")

    @property
    def local_slots(self) -> int:
        """Bloom slots a shard owns (padded to a multiple of 32)."""
        s = -(-(1 << self.base.f) // self.n_shards)
        return ((s + 31) // 32) * 32

    def cap(self, n_slots: int) -> int:
        """Send slots a (source, destination) pair for n_slots indices a
        shard."""
        per_dev = n_slots / self.n_shards
        c = int(per_dev * self.slack) + 256
        return min(n_slots, ((c + 127) // 128) * 128)

    def _indices(self, edges: int) -> int:
        cfg = self.base
        return (cfg.B // self.n_shards) * cfg.P * edges * cfg.q

    @property
    def fill_cap(self) -> int:
        return self.cap(self._indices(4))

    @property
    def mark_cap(self) -> int:
        return self.cap(self._indices(8))

    def shard_bytes(self) -> int:
        """Device bytes a shard holds through a round's mark: its filter,
        and a batch's mark buffers (its probes' u32 send slots, the u64
        send and received slots, the u8 hits both ways, the bucketing's
        look-back scratch)."""
        cfg = self.base
        filt = self.local_slots if cfg.layout == "byte" else self.local_slots // 8
        probes = self._indices(8)
        slots = self.n_shards * self.mark_cap
        scratch = shardbloom.scratch_bytes((cfg.B // self.n_shards) * cfg.P, self.n_shards,
                                           cfg.q, cfg.f, marking=True)
        return filt + 4 * probes + 18 * slots + scratch


def make_sharded_filter(mesh, scfg: ShardedConfig) -> dict:
    """{s: shard s's zeroed filter (local_slots in the byte or bit layout)
    on mesh.device(s)} for this process's shards (sharded.py:86)."""
    cfg = scfg.base
    return {
        s: bloom.make_filter(cfg.f, cfg.layout, mesh.device(s), slots=scfg.local_slots)
        for s in mesh.shards
    }


def _counters(counters, mesh) -> dict:
    if counters is not None:
        return counters
    return {s: torch.zeros(1, dtype=torch.int64, device=mesh.device(s)) for s in mesh.shards}


def sharded_fill_step(mesh, scfg: ShardedConfig, ops: Ops = KERNELS):
    """The sharded fill (sharded.py:214) as a function

        step(filt, batch, low, high, overflow=None) -> overflow

    filt: make_sharded_filter's shards, filled in place; batch: {s:
    (packed, nmask, valid)}, shard s's B/D rows of a batch in the upload
    form on mesh.device(s); [low, high]: the round's vertex-hash interval.
    overflow: {s: (1,) int64 on mesh.device(s)}, the fill indices that
    shard s could not send, added to (new counters when None); any
    overflow is a false negative, so the caller raises on it."""
    cfg = scfg.base
    D, cap = scfg.n_shards, scfg.fill_cap

    def step(filt, batch, low: int, high: int, overflow=None):
        overflow = _counters(overflow, mesh)
        sends = {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                send, overflow[s] = ops.bucket_fill(*batch[s], low, high, cfg=cfg, n_shards=D,
                                                    cap=cap, overflow=overflow[s])
                sends[s] = (send,)
        recv = mesh.all_to_all(sends)
        del sends
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                ops.fill_local(filt[s], recv[s][0].view(D, cap), cfg.layout)
        return overflow

    return step


def sharded_mark_step(mesh, scfg: ShardedConfig, ops: Ops = KERNELS):
    """The sharded mark (sharded.py:229) as a function

        step(filt, batch, low, high, overflow=None, count=None)
            -> (masks, count, overflow)

    Arguments as the fill step's. masks: {s: (B/D, P/8) uint8 packed
    candidate mask of shard s's rows}; count: {s: (1,) int64}, the
    candidates, added to; overflow: the probes that could not be sent,
    added to (a probe not sent reads as a miss)."""
    cfg = scfg.base
    D, cap = scfg.n_shards, scfg.mark_cap

    def step(filt, batch, low: int, high: int, overflow=None, count=None):
        overflow = _counters(overflow, mesh)
        count = _counters(count, mesh)
        sends, slots = {}, {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                send, slots[s], overflow[s] = ops.bucket_mark(
                    *batch[s], low, high, cfg=cfg, n_shards=D, cap=cap, overflow=overflow[s])
                sends[s] = (send,)
        recv = mesh.all_to_all(sends)
        del sends
        hits = {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                hits[s] = (ops.probe_local(filt[s], recv[s][0].view(D, cap),
                                           cfg.layout).view(D, cap),)
        del recv
        back = mesh.all_to_all(hits)
        del hits
        masks = {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                masks[s], count[s] = ops.mark_finish(back[s][0], slots[s], *batch[s], low, high,
                                                     cfg=cfg, count=count[s])
        return masks, count, overflow

    return step
