"""The distributed sort-join engine: FASTA in, .dbg out, over a mesh of D
shards (parallel/mesh.py).

The port of twopaco_tpu/parallel/distpipe.py:329 build_junctions_dist,
with its Bloom gate (bloom_gate=True, `--tpu-engine dist-bloom`). The same
contract as the single-device engines: deterministic, byte-identical
output. Hash intervals split the run across time (rounds, as the sort
engine's -r); k-mer ranges split each round across space (shards), so a
round's records are spread over D sorts of 1/D the size each.

  1. measurement: the canonical word0 histogram of every batch, one
     launch a shard over its resident batches (passes/histogram.py
     word0_histogram_batches), gives the routing bounds, D ranges of equal
     record mass (GC bias makes a uniform word0 split badly skewed); with
     more than one round, the vertex-hash histogram (one launch a shard)
     gives the round intervals;
  2. per round, per batch, per shard: the records of the shard's B/D rows
     gated to the round (records.cu), routed by the bounds (route.cu, into
     send buffers allocated once a round), exchanged (mesh.all_to_all),
     and the received real records appended to the shard's round buffer
     (compact.cu) at a device-side offset;
     with the Bloom gate, the round first fills a Bloom filter sharded by
     slot over the mesh with every batch (parallel/sharded.py, a fill
     overflow raises), and each batch's records are built only at the
     positions its sharded mark finds candidate (the rest become
     sentinels, which route drops): only candidates are routed, sorted
     and judged, and every occurrence of a k-mer gets the same decision
     (the filter holds all of its edges), so the bytes do not change;
  3. per round, per shard: sort (sort.cu) and judge + compact (judge.cu)
     of the buffer's records, the occurrences sorted by position as u64
     merge keys (occ_pack.cu); each (round, shard) block is one entry of
     the sort engine's merge (passes/sortpipe.py merge_fetched): hash
     intervals x k-mer ranges partition the k-mer space.

A checkpointed round is one raw entry, the shards' blocks concatenated in
shard order with ids offset by the running table length (the sort
engine's format). In a multi-process mesh rank 0 writes the checkpoints
and the .dbg; barriers order checkpoint reads after the writes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.parallel.mesh import local_mesh, on_device
from twopaco_tpu_torch.parallel.sharded import (
    ShardedConfig, make_sharded_filter, sharded_fill_step, sharded_mark_step,
)
from twopaco_tpu_torch.parallel.sortshard import KERNELS, PLAIN
from twopaco_tpu_torch.passes import route, sortpipe, stream
from twopaco_tpu_torch.passes.histogram import BIN_POW
from twopaco_tpu_torch.passes.pipeline import (
    Enumerator,
    PassConfig,
    PipelineConfig,
    RunStats,
    _input_fingerprint,
)

# the sort engine's phase keys, plus route (routing, exchange and append)
# and the Bloom gate's fill and mark (0 without it)
PHASES = (
    "read", "windows", "upload", "hist", "fill", "mark", "build", "route", "sort",
    "judge", "fetch", "merge", "emit",
)
ROUND_PHASES = ("fill", "mark", "build", "route", "sort", "judge", "fetch")


@dataclass(frozen=True)
class DistConfig:
    """Shapes of the distributed engine."""

    base: PassConfig
    n_shards: int
    dev_slots: int  # a shard's round buffer
    route_cap: int  # send slots a (source, destination) pair, a batch

    @property
    def block(self) -> int:
        """Records a shard receives a batch (its append headroom)."""
        return self.n_shards * self.route_cap


def route_bounds_from_hist(hist: np.ndarray, n_devices: int, bin_pow: int = BIN_POW) -> np.ndarray:
    """(D-1,) ascending uint32 word0 boundaries of ~equal record mass
    (twopaco_tpu distpipe.py:116).

    Bucketing is owner = #{bounds < word0} (searchsorted side='left'),
    so device d owns word0 in (bounds[d-1], bounds[d]]. Ownership is a
    pure function of word0, so all records of one k-mer land on one
    device regardless of where boundaries fall."""
    D = n_devices
    total = int(hist.sum())
    csum = np.cumsum(hist)
    targets = (np.arange(1, D) * total) / D
    bins = np.searchsorted(csum, targets, side="left")
    shift = 32 - bin_pow
    bounds = ((bins + 1) << shift).astype(np.uint64)
    # strictly increasing even on degenerate histograms
    bounds = np.maximum.accumulate(bounds)
    bump = np.arange(D - 1, dtype=np.uint64)
    bounds = np.minimum(bounds + 0, (1 << 32) - (D - 1) + bump)
    for i in range(1, D - 1):
        if bounds[i] <= bounds[i - 1]:
            bounds[i] = bounds[i - 1] + 1
    return bounds.astype(np.uint32)


def plan_dist(config: PipelineConfig, mesh, n_slots: int, free: int | None):
    """-> (n_rounds, route_cap): the round count (at least -r) and the send
    slots of a (source, destination) pair (twopaco_tpu distpipe.py:411,
    :441). A shard's sort is sized as the sort engine sizes a round
    (sortpipe.plan_rounds) over its 1/D of the records, from config.sort_chunk
    or from `free`, the device memory one shard may use."""
    D = mesh.n_shards
    per_batch_dev = (config.rows_per_batch // D) * config.positions_per_row
    route_cap = min(
        per_batch_dev,
        ((int(per_batch_dev / D * config.round_slack) + 256 + 127) // 128) * 128,
    )
    n_rounds, _buf = sortpipe.plan_rounds(config, -(-n_slots // D), D * route_cap, free)
    return n_rounds, route_cap


def _shard_free(mesh) -> int | None:
    """Device bytes every shard may use: the least over the mesh of a
    device's free memory divided among the shards that share it (None on
    the CPU). Every process plans with the same number."""
    free = {}
    for s in mesh.shards:
        dev = mesh.device(s)
        f = sortpipe._free_bytes(dev)
        free[s] = torch.tensor([-1 if f is None else f // mesh.shards_per_device(s)],
                               dtype=torch.int64, device=dev)
    least = int(mesh.all_gather(free).min())
    return None if least < 0 else least


def build_junctions_dist(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    mesh=None,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    *,
    device="cuda",
    reference: bool = False,
    bloom_gate: bool = False,
) -> Enumerator:
    """Mesh-parallel counterpart of sortpipe.build_junctions_sorted (same
    arguments, byte-identical output). mesh: a parallel/mesh.py mesh, by
    default one shard per visible CUDA device (device "cuda") or one CPU
    shard (device "cpu"). In a multi-process mesh every process calls this
    with the same arguments; rank 0 writes the .dbg and the checkpoints.
    reference=True runs the plain versions on any device. bloom_gate=True
    (dist-bloom) routes only the candidates of a Bloom filter of 2^f slots
    (config.filter_bits, hash_functions, layout) sharded over the mesh."""
    dev = sortpipe.resolve_device(device)
    if mesh is None:
        mesh = local_mesh(dev)
    ops = PLAIN if reference else KERNELS
    D = mesh.n_shards
    k, P, B, w = config.k, config.positions_per_row, config.rows_per_batch, config.w
    if B % D:
        raise ValueError(
            f"rows_per_batch ({B}) must be a multiple of the mesh size ({D})"
        )
    # the filter's layout is resolved for a shard's slots, so -f 36..40
    # run once the mesh is wide enough (the layout's errors come first)
    scfg = (
        ShardedConfig(base=config.pass_config(shard_devices=D), n_shards=D)
        if bloom_gate else None
    )
    rows = B // D
    stats = RunStats()
    stats.timings.update(dict.fromkeys(PHASES, 0.0))
    t_start = time.time()

    # every process reads the input (host work); a shard uploads its rows
    sequences, batches = sortpipe.read_batches(input_paths, sequences, config, stats)
    uploads = {
        s: sortpipe.upload_batches(batches, mesh.device(s), stats,
                                   rows=slice(s * rows, (s + 1) * rows))
        for s in mesh.shards
    }
    n_slots = len(batches) * B * P
    wide = sortpipe.wide_layout(config, n_slots)
    id_bits = sortpipe.key_id_bits(n_slots, len(sequences), wide)
    log(
        f"Engine = distributed {'bloom-gated ' if bloom_gate else ''}sort-join over {D} "
        f"shards ({dev.type})\nVertex length = {k}\nRecord slots = {n_slots}"
    )
    free = _shard_free(mesh)
    if scfg is not None:
        need = scfg.shard_bytes()
        log(f"Hash functions = {config.hash_functions}\nFilter size = {1 << config.filter_bits} "
            f"({scfg.base.layout} layout, {scfg.local_slots} slots a shard)")
        if free is not None:
            # each shard's filter and mark buffers live through its round
            if need >= free:
                raise RuntimeError(
                    f"a shard's Bloom filter and mark buffers ({sortpipe._gib(need)}) do not "
                    f"fit its free device memory ({sortpipe._gib(free)}): shard over more "
                    "devices or lower -f/--filtermemory"
                )
            free -= need

    n_rounds, route_cap = plan_dist(config, mesh, n_slots, free)
    # measurement passes: routing bounds (canonical word0 mass) and round
    # intervals (vertex-hash mass)
    t0 = time.time()
    whist, hhist = {}, {}
    for s in mesh.shards:
        with on_device(mesh.device(s)):
            whist[s] = ops.word0(uploads[s], k=k, P=P)
            hhist[s] = (ops.histogram(uploads[s], k=k, P=P) if n_rounds > 1
                        else torch.zeros_like(whist[s]))
    both = mesh.all_gather({s: torch.cat([whist[s], hhist[s]]).to(torch.int64)
                            for s in mesh.shards}).sum(axis=0)
    bounds = route_bounds_from_hist(both[: 1 << BIN_POW], D)
    bounds_d = {
        s: pack.as_u32(torch.from_numpy(bounds.astype(np.int64)).to(mesh.device(s)))
        for s in mesh.shards
    }
    intervals = (
        sortpipe._live_intervals(both[1 << BIN_POW :], n_rounds) if n_rounds > 1
        else [(0, MASK32)]
    )
    stats.timings["hist"] = time.time() - t0
    if len(intervals) > 1:
        log(f"Splitting the input kmers set ({len(intervals)} rounds)")
    # no filter here: PassConfig carries the shapes only (any -f runs)
    dcfg = DistConfig(
        base=PassConfig(k=k, positions_per_row=P, rows_per_batch=B), n_shards=D,
        route_cap=route_cap,
        dev_slots=int(n_slots / len(intervals) / D * config.round_slack) + D * route_cap,
    )

    fingerprint = None
    if checkpoint_dir is not None:
        fingerprint = _input_fingerprint(input_paths, sequences)
    # the writer checks (and, on a mismatch, clears) the directory first
    if mesh.is_writer():
        ckpt = sortpipe._Checkpoint(checkpoint_dir, config, n_slots, intervals, fingerprint)
    mesh.barrier("ckpt_init")
    if not mesh.is_writer():
        ckpt = sortpipe._Checkpoint(checkpoint_dir, config, n_slots, intervals, fingerprint,
                                    read_only=True)

    fetched = []
    for r, (low, high) in enumerate(intervals):
        restored = ckpt.load_round(r)
        if restored is not None:
            entry, rstats = restored
            fetched.append(entry)
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        log(f"Round {r}, {low}:{high}")
        entries, rstats = _run_round(mesh, ops, dcfg, batches, uploads, bounds_d,
                                     low, high, config.abundance, id_bits, n_slots, scfg)
        stats.rounds.append(rstats)
        for key in ROUND_PHASES:
            stats.timings[key] += rstats[f"t_{key}"]
        log(
            f"Round {r} seconds: " + " ".join(
                f"{key}={rstats[f't_{key}']:.4f}" for key in ROUND_PHASES
            ) + f"\nTrue junctions = {rstats['true_junctions']}\n"
            f"Distinct k-mers = {rstats['hash_table_size']}\n"
            + (f"Candidate marks count = {rstats['marks']}" if bloom_gate
               else f"Occurrences = {rstats['marks']}")
        )
        if checkpoint_dir is not None:
            entry = _round_entry(entries, w)
            if mesh.is_writer():
                ckpt.save_round(r, entry, rstats)
            # no process resumes past a round whose file is not written yet
            mesh.barrier(f"ckpt_round_{r}")
            fetched.append(entry)
        else:
            fetched.extend(entries)

    del uploads
    return sortpipe.merge_fetched(
        fetched, batches, config, out_path if mesh.is_writer() else None, stats, log,
        t_start, n_slots=n_slots, wide=wide, n_sequences=len(sequences),
    )


def _fill_round(mesh, ops, scfg: ShardedConfig, uploads, n_batches: int, low: int,
                high: int) -> dict:
    """The round's sharded Bloom filter, filled with every batch -> {s:
    shard}; raises on a fill that could not be sent (a false negative)."""
    filt = make_sharded_filter(mesh, scfg)
    step = sharded_fill_step(mesh, scfg, ops)
    over = None
    for b in range(n_batches):
        over = step(filt, {s: uploads[s][b] for s in mesh.shards}, low, high, over)
    n_over = int(mesh.all_gather(over).sum())
    if n_over:
        raise RuntimeError(
            f"sharded Bloom fill route overflow ({n_over}) — raise ShardedConfig.slack"
        )
    return filt


def _run_round(mesh, ops, dcfg: DistConfig, batches, uploads, bounds_d, low: int,
               high: int, abundance: int, id_bits: int | None, n_slots: int,
               scfg: ShardedConfig | None = None):
    """One round over the mesh -> (merge entries of every shard in shard
    order, on every process; the round's stats). scfg: the Bloom gate's
    sharded filter, or None for none."""
    cfg = dcfg.base
    D, P, w = dcfg.n_shards, cfg.P, cfg.w
    rows = cfg.B // D
    t_fill = t_mark = t_build = t_route = 0.0
    filt = marks = None
    if scfg is not None:
        t0 = time.time()
        filt = _fill_round(mesh, ops, scfg, uploads, len(batches), low, high)
        mark_step = sharded_mark_step(mesh, scfg, ops)
        t_fill = time.time() - t0
    masks = dict.fromkeys(mesh.shards)
    bufs, over = {}, {}
    recs, send = {}, {}
    for s in mesh.shards:
        d = mesh.device(s)
        bufs[s] = stream.new_round_buffer(dcfg.dev_slots, w, d)
        over[s] = torch.zeros(1, dtype=torch.int64, device=d)
        send[s] = route.new_send(D, dcfg.route_cap, w, d)
        recs[s] = (
            torch.empty((rows * P, w), dtype=torch.uint32, device=d),
            torch.empty(rows * P, dtype=torch.uint32, device=d),
            torch.empty(rows * P, dtype=torch.int64, device=d),
        )
    for b, batch in enumerate(batches):
        if filt is not None:
            # mark probes that cannot be sent count as route drops
            t0 = time.time()
            masks, marks, over = mark_step(filt, {s: uploads[s][b] for s in mesh.shards},
                                           low, high, over, marks)
            for s in mesh.shards:
                sortpipe._sync(mesh.device(s))
            t_mark += time.time() - t0
        t0 = time.time()
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                ops.build(*uploads[s][b], (batch.row0 + s * rows) * P, k=cfg.k, P=P,
                          low=low, high=high, out=recs[s], mask=masks[s])
        for s in mesh.shards:
            sortpipe._sync(mesh.device(s))
        t1 = time.time()
        sends = {}
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                *sends[s], _ = ops.route(*recs[s], D, dcfg.route_cap, bounds=bounds_d[s],
                                         overflow=over[s], out=send[s])
        recv = mesh.all_to_all(sends)
        for s in mesh.shards:
            with on_device(mesh.device(s)):
                buf, state = bufs[s]
                ops.compact(*recv[s], buf, state, dcfg.dev_slots - dcfg.block)
        for s in mesh.shards:
            sortpipe._sync(mesh.device(s))
        t_build += t1 - t0
        t_route += time.time() - t1

    del filt, masks  # the filter is freed before the finish
    # (route drops, buffer fill, buffer overflow) of every shard
    t0 = time.time()
    fill = mesh.all_gather({s: torch.cat([over[s], bufs[s][1]]) for s in mesh.shards})
    n_marks = None if marks is None else int(mesh.all_gather(marks).sum())
    t_route += time.time() - t0
    overflow = int(fill[:, 0].sum() + fill[:, 2].sum())
    if overflow:
        raise RuntimeError(
            f"distributed record buffer overflow ({overflow} routing/append drops) — "
            "raise PipelineConfig.round_slack or rounds"
        )

    t_sort = t_judge = t_fetch = 0.0
    blocks = {}
    for s in mesh.shards:
        d = mesh.device(s)
        with on_device(d):
            n = int(fill[s, 1])
            (bw, bpay, bpos), _state = bufs.pop(s)
            t0 = time.time()
            sw, spay, spos = ops.sort(bw[:n], bpay[:n], bpos[:n], key_bits=2 * cfg.k)
            del bw, bpay, bpos
            sortpipe._sync(d)
            t1 = time.time()
            table_d, occ_pos_d, occ_id_d, n_groups, n_junc, n_occ = ops.judge(
                sw, spay, spos, abundance)
            del sw, spay, spos
            occ_d = sortpipe.finish_occurrences(ops, occ_pos_d, occ_id_d, id_bits, n_slots)
            del occ_pos_d, occ_id_d
            sortpipe._sync(d)
            t2 = time.time()
            entry = sortpipe.fetch_entry(table_d, occ_d, id_bits)
            del table_d, occ_d
            t3 = time.time()
        t_sort += t1 - t0
        t_judge += t2 - t1
        t_fetch += t3 - t2
        blocks[s] = (entry, n_groups, n_junc, n_occ)
    t0 = time.time()
    gathered = mesh.gather(blocks)
    t_fetch += time.time() - t0
    rstats = dict(
        low=low, high=high,
        marks=sum(g[3] for g in gathered) if n_marks is None else n_marks,
        hash_table_size=sum(g[1] for g in gathered),
        true_junctions=sum(g[2] for g in gathered),
        false_positives=0,
        t_fill=t_fill, t_mark=t_mark, t_build=t_build, t_route=t_route, t_sort=t_sort,
        t_judge=t_judge, t_fetch=t_fetch,
    )
    return [g[0] for g in gathered], rstats


def _round_entry(entries, w: int):
    """The shards' entries of a round as one raw entry (checkpoints):
    tables concatenated in shard order (the round's global k-mer order),
    local ids offset by the running table length."""
    tables, pos, ids = [], [], []
    t_off = 0
    for entry in entries:
        table, occ_pos, occ_ids = sortpipe.raw_entry(entry)
        tables.append(table)
        pos.append(occ_pos.astype(np.int64))
        oi = occ_ids.astype(np.int64)
        ids.append(oi + np.sign(oi) * t_off)
        t_off += len(table)
    return (
        np.concatenate(tables) if tables else np.zeros((0, w), np.uint32),
        np.concatenate(pos) if pos else np.zeros(0, np.int64),
        np.concatenate(ids) if ids else np.zeros(0, np.int64),
    )
