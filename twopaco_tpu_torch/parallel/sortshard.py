"""One distributed sort-join step over a mesh (parallel/mesh.py).

The port of twopaco_tpu/parallel/sortshard.py. Records are routed by the
top bits of their canonical first k-mer word, so shard d owns a
contiguous slice of k-mer space. Consequences:

  - each shard's locally sorted record block is a contiguous piece of the
    global sort order: the shards' junction tables concatenate, in shard
    order, into the globally sorted dictionary;
  - global junction ids = local rank + the exclusive prefix of the
    shards' junction counts (one all_gather of D scalars);
  - occurrences are judged entirely locally after one all_to_all.

Rows are data-parallel in (shard s builds the records of rows
[s*B/D, (s+1)*B/D) of the batch) and k-mer-range-sharded out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from twopaco_tpu_torch.parallel.mesh import on_device
from twopaco_tpu_torch.passes import judge, route
from twopaco_tpu_torch.passes.pipeline import PassConfig
from twopaco_tpu_torch.passes.versions import KERNELS, Ops


@dataclass(frozen=True)
class SortShardConfig:
    base: PassConfig
    n_shards: int
    slack: float = 2.0  # record routing is content-skewed; be generous

    def __post_init__(self):
        if self.base.B % self.n_shards:
            raise ValueError(
                f"rows_per_batch ({self.base.B}) must be a multiple of the mesh "
                f"size ({self.n_shards})"
            )

    def cap(self) -> int:
        """Send slots a (source, destination) pair (sortshard.py:46)."""
        per_dev_records = (self.base.B // self.n_shards) * self.base.P
        c = int(per_dev_records / self.n_shards * self.slack) + 256
        return ((c + 127) // 128) * 128


def global_ids(ids, offset: int):
    """Local +-rank ids -> global ids: sign * (|id| + offset), 0 stays 0."""
    ids = ids.to(torch.int64)
    return torch.where(ids != 0, torch.sign(ids) * (ids.abs() + offset), 0)


def sharded_sort_step(mesh, scfg: SortShardConfig, check_abundance: bool = False,
                      ops: Ops = KERNELS):
    """The full distributed step (sortshard.py:164) as a function

        step(batch, low, high, abundance) -> (blocks, n_junc, n_occ, overflow)

    batch: {s: (packed, nmask, valid)} of this process's shards, shard s's
    B/D rows of the batch in the upload form on mesh.device(s) (mesh.put_rows
    of pack.pack_codes_host's arrays), positions counted from the batch's
    row 0. Per shard: the records of its rows gated to [low, high], routed
    by the uniform word0 split, exchanged, sorted and judged record by
    record. blocks: {s: (sorted words, positions, keep_first, global ids
    int64)}; n_junc, n_occ, overflow: host ints summed over the mesh. The
    abundance limit applies only with check_abundance (exact: each k-mer's
    records live on one shard)."""
    cfg = scfg.base
    D, P = mesh.n_shards, cfg.P
    rows = cfg.B // D
    cap = scfg.cap()
    # every step routes into the same send buffers
    send = {s: route.new_send(D, cap, cfg.w, mesh.device(s)) for s in mesh.shards}

    def step(batch, low: int, high: int, abundance: int):
        ab = abundance if check_abundance else judge.NO_ABUNDANCE
        sends, over = {}, {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                recs = ops.build(*batch[s], s * rows * P, k=cfg.k, P=P, low=low, high=high)
                *sends[s], over[s] = ops.route(*recs, D, cap, out=send[s])
        recv = mesh.all_to_all(sends)
        local = {}
        counts = {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                sw, spay, spos = ops.sort(*recv[s], key_bits=2 * cfg.k)
                kf, _keep, ids, _ng, n_junc, n_occ = ops.judge_records(sw, spay, ab)
                local[s] = (sw, spos, kf, ids)
                counts[s] = torch.cat([
                    torch.tensor([n_junc, n_occ], dtype=torch.int64, device=over[s].device),
                    over[s],
                ])
        table = mesh.all_gather(counts)  # (D, 3): n_junc, n_occ, overflow
        offsets = np.concatenate([[0], np.cumsum(table[:, 0])[:-1]])
        blocks = {
            s: (sw, spos, kf, global_ids(ids, int(offsets[s])))
            for s, (sw, spos, kf, ids) in local.items()
        }
        n_junc, n_occ, overflow = (int(v) for v in table.sum(axis=0))
        return blocks, n_junc, n_occ, overflow

    return step
