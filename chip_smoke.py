#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from twopaco_tpu_torch/kernels/csrc;
   then (upload) reads the slice's FASTA as the main path does, into one
   host buffer with the window rows' table (sortpipe.read_batches), times
   its page-locking and its H2D, holds upload.cu against its plain version on every one
   of the slice's rows (timed against its bound) and, batch by batch,
   against the host windows and pack_codes_host (the same words and
   metadata); the uploads of the compares below are the kernel's;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes of the benchmark slice (exact: integer data), and times
   both with CUDA events: the record build first on the -r 1 round's
   table of every batch (one launch, as the main path builds it), then on
   one batch, on one shard's batch of the dist append and at k = 101; the
   round sort also on the slice's k = 101 round (sort_records_k101, 7 key
   words); both judges also on the slice's round and, untimed, on the
   edge inputs of twopaco_tpu_torch/testing/judge_cases.py (a group over
   many tiles with saturated N-in counts, tile-edge groups, one record,
   counts off the tile, over 2^24 records, all and mostly sentinels),
   abundance none and 3; the round partition first on the -r 4 pass's
   table of every batch (one call, as the resident path makes it), then
   on one batch; the compaction on one batch, on four batches' records in
   one append (2048 look-back tiles), and the same appended past lim (the
   overflow flag) and at an offset past lim (the write clamped);
4. runs the port's CLI on two inputs whose .dbg sha256 the JAX package
   gave (tests/golden/torch_port_sha256.json) and checks the bytes; then
   the port's graphdump on the k = 101 .dbg of tests/golden/largek.fa,
   whose group text must equal the reference graphdump's golden and whose
   gfa1 must hold the golden's records and spell every input sequence
   (its segment ids follow the junction ids, which the reference numbers
   in another order); then the self test (testing/selftest.py, the sort
   and Bloom engines against the naive oracle) at a small sweep on the
   card;
5. runs the slice: 8 genomes x 8,000,000 bases (seed 2016) through
   `twopaco_tpu_torch.cli.twopaco.main(["-k", "25", "-f", "30", ...])`,
   with every kernel's launch counter reset just before and read just
   after; it must launch the upload and the record build once and no
   merge (one round's entry is merged already); its .dbg sha256 must be
   SLICE_SHA256; then the same input
   through the plain versions on the card, whose .dbg must be
   byte-identical;
6. runs the slice in four rounds (-r 4) in each multi-round mode:
   resident, grouped (TWOPACO_RESIDENT_BYTES at half the resident
   blocks' bytes: 2 groups of 2 rounds), stream (TWOPACO_RESIDENT=0 and
   TWOPACO_GROUPED=0) and histogram split (TWOPACO_UNIFORM_SPLIT=0), each
   with the counters reset just before and read just after; each must
   launch its mode's kernels (the partition once a pass: once, or once a
   group), the upload once and merge.cu's two entries once, and write the
   -r 1 run's bytes; then -r 4 resident through the
   plain versions on the card, the same bytes again;
7. holds the Bloom engine's four kernels (fill, mark, extract, lookup)
   against their plain versions: fill and mark first on the slice's
   round, its 123 batches in one launch each (as the main path calls
   them; the fill timed into a zeroed filter, each version filling its
   own; the two filters must then be equal), then on one batch against the
   whole slice's filter, in the byte layout at f=30, the bit layout at
   f=34 (64-bit probe indices) and the block layout at f=30; the extract
   first over the round's 123 batches and byte masks in one call (as the
   round makes it), then on batch 0; the lookup (its hits as 8-byte
   occurrence keys) first over the round's 123 batches and byte masks in
   one call (as pass 4 makes it), then on batch 0, against the slice's
   junction table;
8. runs the slice through the Bloom engine (`--tpu-engine bloom`): -f 30
   (auto: byte), --tpu-layout bit -f 34, --tpu-layout block -f 30, and
   -f 30 -r 4, each with the counters reset just before and read just
   after; each must launch the Bloom kernels and the sort and judge of
   its verify pass, the fill, the mark and the extract exactly once a
   round, the lookup once a run, write its keys on the card (one emit.cu
   check, a chunk launch or more) and write SLICE_SHA256; a one-round run must count the candidates that the round
   mark of its layout counted in step 7; then a Bloom run through the
   plain versions on the card, the same bytes again;
9. holds the distributed engine's four kernels against their plain
   versions at the slice's shapes: the word0 histogram of shard 0's 123
   batches in one launch (as the path measures it) and of one batch;
   route (D=4, one batch's shard, into send buffers allocated once, by
   the slice's measured word0 bounds and by the uniform split),
   judge_records on one batch of the slice's
   shape cut from the starts of all 8 genomes (a slice batch holds one
   genome, so no junction), and the occurrence sort on the -r 1 round's
   occurrences; then sharded_sort_step on that batch over 4 shards of
   the card, whose table and occurrences must equal the one-shard sort +
   judge_records;
10. runs the slice through the distributed engine, each with the counters
   reset just before and read just after, each launching its kernels (a
   4-shard run: the upload once a shard, the merge once) and writing
   SLICE_SHA256: build_junctions_dist over a LocalMesh of 4
   shards of the card at -r 1 and -r 4, the CLI's `--tpu-engine dist`
   (one shard), build_junctions_multihost in a child process under a
   one-rank NCCL group, and the 4-shard run through the plain versions;
   then (merge) holds merge.cu's two entries (merge_rows, merge_keys)
   against their plain versions on the keyed entries of the -r 4 resident
   run (4), the 4-shard run (4) and the 4-shard -r 4 run (16), timed
   against their bounds (merge_keys also against one torch.sort of its
   keys), and the device merge as the path runs it against the plain
   versions on the card and the host merge (equal tables and keys, host
   seconds in turns);
11. holds the dist-bloom engine's four kernels (bloom_shard.cu: bucket,
   fill, probe, mark finish) against their plain versions at one slice
   batch's shard, the sharded filter filled with the whole slice: byte
   layout at f=30 over 4 shards of the card (the whole filter also filled
   by the plain versions and compared, and the batch's mask equal to the
   Bloom engine's), bit layout at f=36 (64-bit global and local slots), 3
   shards (255 rows a batch), and a tiny cap whose overflow counts must
   match; the byte fill is also timed into a zeroed shard, every slot new;
   the device kernels of one call each of the route, the bucket's two
   modes, the record build's table (one kernel), both judges (two kernels
   each), the -r 4 partition pass (two), the compaction (two), and the
   Bloom lookup and extract of the -r 1 run's batches (two each) are
   listed by one
   torch.profiler session; the mark finish (byte f=30, 4 shards) is also
   run at each forced run of 1, 2, 4 and 8 positions a thread, exact, and
   timed on the device;
   the probe is also held against its plain version on hand-made received
   blocks (rows of 0, cap, chunk-boundary and random sent counts; the mark
   cap, and an odd cap starting 8 bytes off 16-byte alignment) (in the
   profiler session: k_route and k_route_tail; one bucketing kernel a
   mode; one k_records; k_judge_scan and k_judge_write a judge;
   k_partition and k_part_tail; k_compact_real and k_compact_rest;
   k_lookup and k_lookup_tail; k_extract and k_extract_tail; no count or
   scan kernel, no memset);
12. runs the slice through the dist-bloom engine, each with the counters
   reset just before and read just after, each launching the four
   entries and the dist engine's kernels and writing SLICE_SHA256:
   build_junctions_dist(bloom_gate=True) over 4 shards of the card at -f 30
   and at -f 36 (the bit layout, 8 GiB of filter, which the Bloom engine
   refuses on one card) at -r 1 and -r 4, the CLI's `--tpu-engine
   dist-bloom -f 30` (one shard), build_junctions_multihost(bloom_gate=True)
   in a one-rank NCCL child process, and the 4-shard -f 30 run through the
   plain versions;
13. (native) loads the port's native host library (io/native.py, g++ at
   first use; every run above already read the FASTA and wrote the .dbg
   through it), holds its encoder against the numpy parser on the
   slice's FASTA (equal headers and codes, both timed), runs the slice at
   sort -r 1 with it and with TWOPACO_NATIVE=0, in turns, printing the
   read, emit, emit_write and merge phases and the wall, and the Bloom
   engine at -f 30 with it, each writing SLICE_SHA256;
14. (serve) times one cold `python -m twopaco_tpu_torch.cli.twopaco`
   process on the slice, then starts `python -m twopaco_tpu_torch.cli.serve
   --device cuda` as a child and asks it through the port's tpclient
   (built with cc): sort -r 1 twice, graphdump -f group of the first .dbg
   (equal to the direct graphdump's text), bad arguments (rc 2), Bloom -f
   30, sort -r 1 again, each .dbg SLICE_SHA256; then __shutdown__, after
   which the child must exit 0 (it is killed whatever happens), and
   prints the cold process's wall beside the first and second served
   requests' client walls.

Every kernel comparison also prints the kernel's bound (the larger of the
bytes it must move over 3.35 TB/s, the filter's traffic counted as each
distinct 32-byte sector that the inputs touch, once, and its integer
operations over 67 T/s)
and, where one PyTorch call computes the same function, that call's time.

Exits non-zero, printing no result, if there is no CUDA device, if the
package is missing, or if any phase fails. The last line of standard
output is the result object.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chip_smoke_work")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_sha256.json")
SLICE = dict(n_seqs=8, length=8_000_000, seed=2016, k=25)
# the slice's .dbg: the one-round run of the first port slice on an H100
# (PERF.md); every later run of the slice must write these bytes. The JAX
# package's CLI wrote the same sha256 on the CPU (twopaco_tpu, 13 resident
# rounds, TWOPACO_NATIVE=0), and so does the port's --device cpu run.
SLICE_SHA256 = "86f34ccc5bb5aa29e69df2b13aa85d3068afe54aca0e3052f93fb731dec2e1cb"
ROUNDS = 4
MODE_VARS = ("TWOPACO_RESIDENT", "TWOPACO_GROUPED", "TWOPACO_RESIDENT_BYTES",
             "TWOPACO_UNIFORM_SPLIT", "TWOPACO_POS64", "TWOPACO_NATIVE")
REPLACES = {
    "build_records": ("twopaco_tpu_torch/kernels/csrc/records.cu",
                      "twopaco_tpu/passes/sortpipe.py:143"),
    "sort_records": ("twopaco_tpu_torch/kernels/csrc/sort.cu",
                     "twopaco_tpu/passes/sortpipe.py:365"),
    "judge_compact": ("twopaco_tpu_torch/kernels/csrc/judge.cu",
                      "twopaco_tpu/passes/sortpipe.py:453"),
    "partition": ("twopaco_tpu_torch/kernels/csrc/partition.cu",
                  "twopaco_tpu/passes/sortpipe.py:166"),
    "assemble": ("twopaco_tpu_torch/kernels/csrc/assemble.cu",
                 "twopaco_tpu/passes/sortpipe.py:237"),
    "compact": ("twopaco_tpu_torch/kernels/csrc/compact.cu",
                "twopaco_tpu/passes/sortpipe.py:338"),
    "histogram": ("twopaco_tpu_torch/kernels/csrc/histogram.cu",
                  "twopaco_tpu/passes/kernels.py:581"),
    "bloom_fill": ("twopaco_tpu_torch/kernels/csrc/bloom_fill.cu",
                   "twopaco_tpu/passes/kernels.py:257"),
    "bloom_mark": ("twopaco_tpu_torch/kernels/csrc/bloom_mark.cu",
                   "twopaco_tpu/passes/kernels.py:400"),
    "bloom_extract": ("twopaco_tpu_torch/kernels/csrc/bloom_extract.cu",
                      "twopaco_tpu/passes/kernels.py:420"),
    "bloom_lookup": ("twopaco_tpu_torch/kernels/csrc/bloom_lookup.cu",
                     "twopaco_tpu/passes/kernels.py:506"),
    "route": ("twopaco_tpu_torch/kernels/csrc/route.cu",
              "twopaco_tpu/parallel/sortshard.py:52"),
    "word0_histogram": ("twopaco_tpu_torch/kernels/csrc/histogram.cu",
                        "twopaco_tpu/parallel/distpipe.py:102"),
    "judge_records": ("twopaco_tpu_torch/kernels/csrc/judge.cu",
                      "twopaco_tpu/passes/sortpipe.py:375"),
    "sort_occurrences": ("twopaco_tpu_torch/kernels/csrc/occ_pack.cu",
                         "twopaco_tpu/passes/sortpipe.py:762"),
    "shard_bucket_fill": ("twopaco_tpu_torch/kernels/csrc/bloom_shard.cu",
                          "twopaco_tpu/parallel/sharded.py:112"),
    "shard_bucket_mark": ("twopaco_tpu_torch/kernels/csrc/bloom_shard.cu",
                          "twopaco_tpu/parallel/sharded.py:112"),
    "shard_fill": ("twopaco_tpu_torch/kernels/csrc/bloom_shard.cu",
                   "twopaco_tpu/parallel/sharded.py:143"),
    "shard_probe": ("twopaco_tpu_torch/kernels/csrc/bloom_shard.cu",
                    "twopaco_tpu/parallel/sharded.py:149"),
    "shard_mark_finish": ("twopaco_tpu_torch/kernels/csrc/bloom_shard.cu",
                          "twopaco_tpu/parallel/sharded.py:155"),
    "upload_rows": ("twopaco_tpu_torch/kernels/csrc/upload.cu",
                    "twopaco_tpu/passes/sortpipe.py:1048"),
    "merge_rows": ("twopaco_tpu_torch/kernels/csrc/merge.cu",
                   "twopaco_tpu/passes/sortpipe.py:1539"),
    "merge_keys": ("twopaco_tpu_torch/kernels/csrc/merge.cu",
                   "twopaco_tpu/passes/sortpipe.py:1539"),
    "emit_check": ("twopaco_tpu_torch/kernels/csrc/emit.cu",
                   "twopaco_tpu/passes/pipeline.py:462"),
    "emit_chunk": ("twopaco_tpu_torch/kernels/csrc/emit.cu",
                   "twopaco_tpu/passes/pipeline.py:462"),
}
# the run whose launch counts each kernel reports: its own path
PATH_OF = {
    "build_records": "r1", "sort_records": "r1", "judge_compact": "r1",
    "partition": "resident", "assemble": "resident", "compact": "stream",
    "histogram": "histogram", "bloom_fill": "bloom_byte", "bloom_mark": "bloom_byte",
    "bloom_extract": "bloom_byte", "bloom_lookup": "bloom_byte",
    "route": "dist_r1", "word0_histogram": "dist_r1", "judge_records": "step",
    "sort_occurrences": "dist_r1", "shard_bucket_fill": "dist_bloom_r1",
    "shard_bucket_mark": "dist_bloom_r1", "shard_fill": "dist_bloom_r1",
    "shard_probe": "dist_bloom_r1", "shard_mark_finish": "dist_bloom_r1",
    "upload_rows": "r1", "merge_rows": "resident", "merge_keys": "resident",
    "emit_check": "r1", "emit_chunk": "r1",
}
D4 = 4  # shards of the card in the distributed runs
FILL_CHUNK = 4096  # received slots a block of bloom_shard.cu's fill
PROBE_CHUNK = 4096  # ... and of its probe
# the kernels each distributed path must launch
DIST_PATH = ("upload_rows", "word0_histogram", "build_records", "route", "compact",
             "sort_records", "judge_compact", "sort_occurrences")
# ... and the merge of more than one entry (every LocalMesh run of D4 shards)
MERGE_PATH = ("merge_rows", "merge_keys")


def card_emit(counts) -> bool:
    """The junction list written on the card: one emit.cu check, a chunk
    launch or more."""
    return counts.get("emit_check") == 1 and counts.get("emit_chunk", 0) >= 1


DIST_BLOOM_PATH = (*DIST_PATH, "shard_bucket_fill", "shard_bucket_mark", "shard_fill",
                   "shard_probe", "shard_mark_finish")
MH_CHILD = r"""
import json, sys, time
import torch
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.parallel import multihost
from twopaco_tpu_torch.passes.pipeline import PipelineConfig
spec = json.loads(sys.argv[1])
build.reset_launch_counts()
t0 = time.time()
enum = multihost.build_junctions_multihost(
    [spec["fa"]], PipelineConfig(**spec["config"]), out_path=spec["out"], device="cuda",
    bloom_gate=spec["bloom_gate"])
torch.cuda.synchronize()
import torch.distributed as dist
print("MH_RESULT " + json.dumps(dict(
    launches=build.launch_counts(), wall=time.time() - t0, vertices=enum.vertices_count,
    world=dist.get_world_size(), backend=dist.get_backend(),
    timings=enum.stats.timings)), flush=True)
dist.destroy_process_group()
"""
# the Bloom engine's runs of the slice: flags, and the layout each must use
BLOOM_RUNS = {
    "bloom_byte": (["-f", "30"], "byte"),
    "bloom_bit": (["--tpu-layout", "bit", "-f", "34"], "bit"),
    "bloom_block": (["--tpu-layout", "block", "-f", "30"], "block"),
    "bloom_r4": (["-f", "30", "-r", str(ROUNDS)], "byte"),
}
BLOOM_PATH = ("upload_rows", "bloom_fill", "bloom_mark", "bloom_extract", "sort_records",
              "judge_compact", "bloom_lookup")


# one H100 SXM's published peaks (NVIDIA's data sheet, at a 700 W limit):
# 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps: int):
    """Mean ms of fn() over reps runs (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    import torch

    from twopaco_tpu_torch.ops import pack

    err = 0
    for a, b in zip(got, want):
        if isinstance(a, (bool, int)):
            err = max(err, abs(int(a) - int(b)))
            continue
        require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.dtype == torch.uint32 and torch.equal(a.view(torch.int32), b.view(torch.int32)):
            continue  # equal (and a GiB-sized filter needs no int64 copy)
        if a.dtype != torch.uint32 and torch.equal(a, b):
            continue
        if a.dtype == torch.uint32:
            a, b = pack.as_i64(a), pack.as_i64(b)
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples and lists included)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: int, ops: int = 0):
    """The least time the card could take: (ms, "bytes" or "operations"),
    the larger of the bytes over the memory rate and the operations over
    the peak rate for their type (integer work counted at the float32
    CUDA-core rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_ops(n_pos: int, n_rows: int, k: int, word0: bool) -> int:
    """Integer operations of a position histogram computed by rolling its
    state along each row: a row's first window from scratch (two strands,
    two operations a char of min(k, 16) chars for word0, of k for the
    vertex hash), then per position the rolled update of both strands, the
    bin and its increment, about a dozen, counted as 12."""
    return n_rows * 4 * (min(k, 16) if word0 else k) + n_pos * 12


def records_ops(n_pos: int, n_rows: int, k: int) -> int:
    """Integer operations of the record build rolled along each row: a
    row's first window from scratch (the two strands' words and hashes, 6
    a char of k), then per position the rolled words and hashes, the gate,
    the canonical choice and the payload, about twenty."""
    return n_rows * 6 * k + n_pos * 20


SECTOR = 32  # bytes of a filter sector, the least that a random access moves


def sector_flags(filt):
    """One flag a 32-byte sector of filt, all clear: the sectors that a
    call touches are flagged, so that each counts once in its bound."""
    import torch

    return torch.zeros(-(-nbytes(filt) // SECTOR), dtype=torch.bool, device=filt.device)


def flag_sectors(flags, slots, layout: str) -> None:
    """Flag the sector of each slot index (byte: 32 slots a sector; bit:
    256) or block index (block: a sector a block)."""
    shift = {"byte": 5, "bit": 8, "block": 0}[layout]
    flags[slots >> shift] = True


def bloom_ops(n_pos: int, k: int, nt: int, q: int, edges: int) -> int:
    """Integer operations of a Bloom pass rolled along runs of 8 positions:
    a run's first window from scratch (4 a char a table), then per position
    the rolled strand hashes (8 a table), the edges' hashes (5 a table an
    edge) and their q indices (3 an index)."""
    return n_pos // 8 * nt * 4 * k + n_pos * (nt * (8 + 5 * edges) + 3 * q * edges)


def fill_sectors(flags, upload, gate, cfg) -> None:
    """Flag the filter sectors that a batch's fill sets a slot in (byte,
    bit: each (position, edge, hash) slot) or writes (block: block(V) and
    block(V_next))."""
    from twopaco_tpu_torch.passes import fill

    codes = fill.batch_codes(upload[0], upload[1], cfg)
    if cfg.layout == "block":
        block, _bits, val = fill.fill_indices_block(codes, upload[2], *gate, cfg)
        flag_sectors(flags, block[val], "block")
    else:
        idx, val = fill.fill_indices(codes, upload[2], *gate, cfg)
        flag_sectors(flags, idx[val], cfg.layout)


def mark_sectors(flags, filt, upload, gate, cfg) -> None:
    """Flag the filter sectors that a batch's decisions read against filt:
    for a position in the round with prev and next ACGT, slot 0 of its six
    other edges, then slot j of each edge whose slots 0 .. j-1 are set
    (byte, bit), or V's block (block)."""
    import torch

    from twopaco_tpu_torch.ops import bloom
    from twopaco_tpu_torch.passes import fill, mark

    codes = fill.batch_codes(upload[0], upload[1], cfg)
    if cfg.layout == "block":
        block, _bits, base, prev, nxt = mark.mark_indices_block(codes, upload[2], *gate, cfg)
        flag_sectors(flags, block[base & (prev < 4) & (nxt < 4)], "block")
        return
    idx, base, prev, nxt = mark.mark_indices(codes, upload[2], *gate, cfg)
    slot_set = bloom.probe(filt, idx, cfg.layout)
    c = torch.arange(4, device=idx.device)
    alive = torch.cat([c != prev[..., None], c != nxt[..., None]], dim=-1)
    alive &= (base & (prev < 4) & (nxt < 4))[..., None]
    for j in range(cfg.q):
        flag_sectors(flags, idx[..., j][alive], cfg.layout)
        alive &= slot_set[..., j]


def lookup_sectors(flags, upload, mask, table, k: int, P: int) -> None:
    """Flag the 32-byte sectors of the (J, w) junction table that the
    lookup's searches of a batch read: each row its lower bound compares
    (the middle row of every step while lo < hi, then the row at lo), the
    sectors of its w words."""
    import torch

    from twopaco_tpu_torch.ops import pack
    from twopaco_tpu_torch.passes import mark, records

    J, w = table.shape
    canon, _pay, _hv, ok = records.batch_records_plain(*upload, k=k, P=P)
    keys = canon[ok & mark.unpack_mask(mask, P).reshape(-1)]
    tab = pack.as_i64(table)
    lo = torch.zeros(len(keys), dtype=torch.int64, device=keys.device)
    hi = torch.full_like(lo, J)

    def touch(rows):
        flags[rows * (4 * w) // SECTOR] = True
        flags[(rows * (4 * w) + 4 * w - 1) // SECTOR] = True

    while bool((lo < hi).any()):
        act = lo < hi
        mid = lo + ((hi - lo) >> 1)
        touch(mid[act])
        right = act & pack.lex_less(tab[mid.clamp(max=J - 1)], keys)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    touch(lo[lo < J])


def probe_sectors(filt, slots, layout: str) -> int:
    """The distinct filter sectors of the slot indices, each once."""
    flags = sector_flags(filt)
    flag_sectors(flags, slots, layout)
    return int(flags.sum())


def count_sectors(fn, filt, uploads) -> int:
    """The distinct sectors of filt (a filter, or the lookup's junction
    table) that fn(flags, upload) flags over the uploads, each once."""
    flags = sector_flags(filt)
    for u in uploads:
        fn(flags, u)
    return int(flags.sum())


def flat(marked):
    """A round mark's (masks, counts) as one tuple of tensors."""
    masks, counts = marked
    return (*masks, counts)


def exact(name, kernel, plain, results, what=""):
    """kernel and plain on the same inputs, untimed: exact agreement,
    recorded beside the name's timed compares."""
    import torch

    err = max_abs_err(kernel(), plain())
    torch.cuda.synchronize()
    require(err == 0, f"{name} {what}: kernel disagrees with its plain version ({err})")
    results.setdefault(name, []).append(dict(max_abs_err=err))
    print(f"exact {name} {what}")


def device_ms(fn, reps: int):
    """Mean device ms of fn() over reps runs queued behind a sleeping kernel,
    so that the host's time to enqueue them is hidden and the CUDA events
    around them time the device's work back to back (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device cycles: longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_each(prepare, fn, reps: int):
    """Mean ms of fn() over reps runs, prepare() before each outside the
    timing (CUDA events around each run)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        prepare()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def compare(name, kernel, plain, reps, results, in_bytes=0, ops=0, out_bytes=None,
            library=None, prepare=None):
    """Run kernel and plain on the same inputs: exact agreement, and
    times taken in turns (plain, kernel, kernel, plain). The bound counts
    in_bytes read, out_bytes written (default: the kernel's outputs) and
    ops integer operations; library: one PyTorch call computing the same
    function, timed beside them (never used by the port); prepare: (for
    kernel, for plain), each run before each of its function's timed calls,
    outside the time (a fill into a zeroed filter)."""
    import torch

    got = kernel()
    err = max_abs_err(got, plain())
    torch.cuda.synchronize()
    require(err == 0, f"{name}: kernel disagrees with its plain version (max abs err {err})")
    bound_ms, bound_by = bound(in_bytes + (nbytes(got) if out_bytes is None else out_bytes), ops)
    del got
    if prepare is None:
        t_kernel = t_plain = timed
    else:
        def t_kernel(fn, n):
            return timed_each(prepare[0], fn, n)

        def t_plain(fn, n):
            return timed_each(prepare[1], fn, n)
    p1 = t_plain(plain, reps)
    k1 = t_kernel(kernel, reps)
    k2 = t_kernel(kernel, reps)
    p2 = t_plain(plain, reps)
    lib_ms = timed(library, reps) if library is not None else None
    results.setdefault(name, []).append(dict(
        max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms,
    ))
    print(f"compare {name}: exact, kernel {(k1 + k2) / 2:.3f} ms, "
          f"plain {(p1 + p2) / 2:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})"
          + (f", library {lib_ms:.3f} ms" if lib_ms is not None else ""))


def fresh_fill_times(tag, filt, kernel, library, trials=10):
    """Single launches of a fill and of its library call into a zeroed
    filter, every slot new (the compare's repeats find them set): mean ms
    of CUDA events around each launch, in turns."""
    import torch

    times = {"kernel": 0.0, "library": 0.0}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(trials):
        for name, fn in (("library", library), ("kernel", kernel)):
            filt.zero_()
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name] += start.elapsed_time(end) / trials
    print(f"{tag} into a zeroed shard: kernel {times['kernel']:.4f} ms, "
          f"library {times['library']:.4f} ms")


def device_kernels(fn) -> dict:
    """{device kernel, copy or memset name: (launches, device ms)} of one
    call of fn, by torch.profiler; names without the "void" and the
    anonymous namespace, cut at their argument list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            out[name.split("(")[0].strip() or e.key] = (e.count, e.self_device_time_total / 1e3)
    return out


def prefix_block(seed, n_sh, cap, slots, dev, offset):
    """A hand-made received (n_sh, cap) block: each row a prefix of random
    local slots below `slots` (0, cap, a probe chunk less one, one, one
    more, a random count), then SENT; offset 1: the block starts 8 bytes
    off 16-byte alignment."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    counts = [0, cap, PROBE_CHUNK - 1, PROBE_CHUNK, PROBE_CHUNK + 1, int(rng.integers(0, cap + 1))]
    blk = np.full((n_sh, cap), -1, np.int64)
    for d in range(n_sh):
        c = min(counts[(d + seed) % len(counts)], cap)
        blk[d, :c] = rng.integers(0, slots, size=c)
    flat = torch.full((n_sh * cap + 1,), -1, dtype=torch.int64, device=dev)
    out = flat[offset:][: n_sh * cap].view(n_sh, cap)
    out.copy_(torch.from_numpy(blk))
    return out


def phase(name):
    print(f"== {name}", flush=True)


def graphdump_text(argv) -> str:
    """The port's graphdump CLI's standard output for argv."""
    from twopaco_tpu_torch.cli import graphdump

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = graphdump.main(argv)
    require(rc == 0, f"graphdump {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def gfa_spells_back(text: str, fa: str, k: int) -> None:
    """A GFA1's paths spell its input: each path's segments, reverse-
    complemented where the path says '-', joined over their k-char
    overlaps, give the FASTA record the path names (segment ids follow the
    junction ids, which the reference numbers in another order, so the
    text itself differs from the reference's)."""
    from twopaco_tpu_torch.io import fasta

    comp = str.maketrans("ACGTN", "TGCAN")
    seg, paths = {}, {}
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == "S" and f[2] != "*":
            seg[f[1]] = f[2]
        elif f[0] == "P":
            paths[f[1]] = f[2].split(",")
    records = list(fasta.read_fasta(fa))
    require(sorted(paths) == sorted(h for h, _c in records), f"gfa1 paths {sorted(paths)}")
    for header, codes in records:
        walk = ""
        for step in paths[header]:
            body = seg[step[:-1]]
            if step[-1] == "-":
                body = body.translate(comp)[::-1]
            require(not walk or walk[-k:] == body[:k], f"gfa1 path {header}: overlap differs")
            walk = walk + body[k:] if walk else body
        require(walk == "".join("ACGTN"[c] for c in codes), f"gfa1 path {header} misspells it")


def run_cli(argv, env=None, echo=True) -> str:
    """The port's CLI main() with the mode variables `env` set (and the
    others unset); echoes its output and returns it."""
    from twopaco_tpu_torch.cli.twopaco import main as cli_main

    saved = {v: os.environ.pop(v, None) for v in MODE_VARS}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
    finally:
        for v, val in saved.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val
    text = buf.getvalue()
    if echo:
        print(text, end="")
    require(rc == 0, f"twopaco {' '.join(argv)} exited {rc}")
    return text


def phase_times(text) -> dict:
    return {
        line.split("\t")[1]: float(line.split("\t")[2])
        for line in text.splitlines() if line.startswith("time\t")
    }


@contextlib.contextmanager
def capture_merge(store: dict):
    """Keep the entries the next run hands sortpipe.merge_fetched."""
    from twopaco_tpu_torch.passes import sortpipe

    orig = sortpipe.merge_fetched

    def capture(fetched, *a, **kw):
        store["fetched"] = list(fetched)
        return orig(fetched, *a, **kw)

    sortpipe.merge_fetched = capture
    try:
        yield store
    finally:
        sortpipe.merge_fetched = orig


def merge_checks(tag, fetched, cfg, dev, results, label) -> None:
    """merge.cu's two entries against their plain versions on a run's
    keyed entries (timed against their bounds; merge_keys against one
    torch.sort of its keys), then the device merge as the path runs it
    (sortpipe.merge_on_device: H2D, merge.cu; its keys fetched here)
    against the plain versions on the card and the host merge, host
    seconds, exact."""
    import numpy as np
    import torch

    from twopaco_tpu_torch.ops import pack
    from twopaco_tpu_torch.passes import merge, occ, sortpipe, versions

    require(len(fetched) > 1 and all(isinstance(e[1], occ.OccKeys) for e in fetched),
            f"merge {tag}: not keyed entries")
    w, id_bits = cfg.w, fetched[0][1].id_bits
    tables = [t for t, _k, _n in fetched]
    keys = [kk.keys for _t, kk, _n in fetched]
    ofs = np.cumsum([[0] + [len(x) for x in keys], [0] + [len(t) for t in tables]], axis=1)
    tab_d = torch.from_numpy(np.concatenate(tables)).to(dev)
    keys_d = torch.cat(keys).to(dev)
    ent_d = torch.from_numpy(ofs).to(dev)
    T, n = tab_d.shape[0], keys_d.numel()
    # the tables read once, the global table, inv and dup written once
    compare("merge_rows", lambda: merge.merge_rows(tab_d, ent_d[1]),
            lambda: merge.merge_rows_plain(tab_d, ent_d[1]), 10, results,
            in_bytes=nbytes(tab_d, ent_d[1]))
    _gt, inv, dup = merge.merge_rows(tab_d, ent_d[1])
    require(int(dup) == 0, f"merge {tag}: {int(dup)} duplicate k-mers")
    # each key read and written once, and each distinct 32-byte sector of
    # inv that the ids reach, once
    rows = ent_d[1][torch.searchsorted(ent_d[0][1:], torch.arange(n, device=dev), right=True)]
    ids = (keys_d & ((1 << id_bits) - 1)) - (1 << (id_bits - 1))
    n_sect = int(torch.unique((rows + ids.abs() - 1) * 4 // SECTOR).numel())
    del rows, ids
    compare("merge_keys", lambda: merge.merge_keys(keys_d, ent_d, inv, id_bits=id_bits),
            lambda: merge.merge_keys_plain(keys_d, ent_d, inv, id_bits=id_bits), 10, results,
            in_bytes=8 * n + SECTOR * n_sect + nbytes(ent_d), out_bytes=8 * n + 16,
            library=lambda: torch.sort(keys_d))
    print(f"merge {tag}: {len(fetched)} entries, {T} junctions, {n} keys; merge_rows and "
          f"merge_keys exact ({n_sect} inv sectors)")
    if w == 2:  # the table's yardstick: torch.sort of its rows as one key
        tkey = ((pack.as_i64(tab_d[:, 0]) - (1 << 31)) << 32) | pack.as_i64(tab_d[:, 1])
        print(f"merge {tag}: library torch.sort of the table's keys "
              f"{timed(lambda: torch.sort(tkey), 10):.4f} ms")
        del tkey
    del tab_d, keys_d, ent_d, inv, _gt
    times = {"device": [], "plain on the card": [], "host": []}
    outs = {}
    for how in ("host", "device", "plain on the card", "device", "host"):
        torch.cuda.synchronize()
        t0 = time.time()
        if how == "host":
            table, inv_h = sortpipe.merge_tables(fetched, w)
            buf = sortpipe.packed_occurrences(fetched, inv_h, 64 - id_bits)
            buf.sort(kind="stable")
        else:
            table, keys_d = sortpipe.merge_on_device(
                fetched, cfg, id_bits, dev,
                versions.KERNELS if how == "device" else versions.PLAIN)
            buf = occ.OccKeys(keys_d, id_bits).host()
            del keys_d
        times[how].append(time.time() - t0)
        outs[how] = (table, buf)
    for how in ("device", "plain on the card"):
        require(np.array_equal(outs[how][0], outs["host"][0])
                and np.array_equal(outs[how][1], outs["host"][1]),
                f"merge {tag}: the {how} merge differs from the host merge")
    print(f"merge {tag} (host clock, in turns) {label}: " + ", ".join(
        f"{how} " + ", ".join(f"{t:.4f}" for t in ts) + " s" for how, ts in times.items())
        + "; equal tables and keys")


def emit_checks(fa, cfg, dev, results, label) -> None:
    """emit.cu's two entries against their plain versions on the slice's
    -r 1 entry, whose keys stay on the card (the check timed over every
    key; the chunk timed as one chunk of every record, against the bytes
    bound), then the card emit as the path runs it (check_keys +
    write_keys: the chunks streamed through two page-locked host buffers)
    against the same emit's plain versions on a CPU copy of the keys (the
    host merge's path), host seconds in turns, each file the slice's
    bytes."""
    import torch

    from twopaco_tpu_torch.passes import emit, occ, sortpipe
    from twopaco_tpu_torch.passes.pipeline import build_junctions

    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=list(fetched), batches=batches)
        return orig(fetched, batches, *a, **kw)

    out = os.path.join(WORK, "emit_r1.dbg")
    sortpipe.merge_fetched = capture
    try:
        build_junctions([fa], cfg, out, device="cuda")
    finally:
        sortpipe.merge_fetched = orig
    require(sha256(out) == SLICE_SHA256, "emit: the -r 1 run's .dbg differs")
    (table, ck, _none), = got["fetched"]
    batches = got["batches"]
    require(isinstance(ck, occ.OccKeys) and ck.keys.is_cuda,
            "emit: the -r 1 entry's keys left the card")
    keys, id_bits, P, n_table = ck.keys, ck.id_bits, cfg.positions_per_row, len(table)
    n = keys.numel()
    _edges, _q, args = emit.check_inputs(batches, n, P, dev)
    compare("emit_check",
            lambda: emit.check(keys, *args, P=P, id_bits=id_bits, n_table=n_table),
            lambda: emit.check_plain(keys, *args, P=P, id_bits=id_bits, n_table=n_table),
            10, results, in_bytes=8 * n + nbytes(args))
    found = emit.check_keys(keys, batches, n_table, P, id_bits, chunk_occ=max(n, 1))
    pl = emit.plan(batches, found, n, n_table, P, id_bits)
    (i0, i1, s0, s1), = pl.bounds
    tabs = [torch.from_numpy(a).to(dev) for a in (pl.rows, pl.gap_slots, pl.gap_recs)]
    bufs = [torch.full((3 * (s1 - s0),), fill, dtype=torch.int32, device=dev)
            for fill in (-7, 0)]  # a word left unwritten differs
    compare("emit_chunk",
            lambda: (emit.chunk(keys, *tabs, bufs[0], i0=i0, i1=i1, s0=s0, P=P,
                                id_bits=id_bits),),
            lambda: (emit.chunk_plain(keys, *tabs, bufs[1], i0=i0, i1=i1, s0=s0, P=P,
                                      id_bits=id_bits),),
            10, results, in_bytes=8 * n + nbytes(tabs), out_bytes=12 * (s1 - s0))
    print(f"emit: {n} keys, {pl.n_stubs} stubs, {s1 - s0 - n - pl.n_stubs} separators, "
          f"{len(pl.gap_slots)} gap records; check and chunk exact")
    del bufs, tabs
    times = {"card": [], "host": []}
    outs = {how: os.path.join(WORK, f"emit_{how}.dbg") for how in times}
    for how in ("host", "card", "card", "host"):
        torch.cuda.synchronize()
        t0 = time.time()
        if how == "card":
            found = emit.check_keys(keys, batches, n_table, P, id_bits)
            emit.write_keys(outs[how], batches, keys, found, n_table, P, id_bits)
        else:
            kc = torch.from_numpy(ck.host().view("int64"))
            found = emit.check_keys(kc, batches, n_table, P, id_bits, fn=emit.check_plain)
            emit.write_keys(outs[how], batches, kc, found, n_table, P, id_bits,
                            fn=emit.chunk_plain)
        times[how].append(time.time() - t0)
    for how, path in outs.items():
        require(sha256(path) == SLICE_SHA256, f"emit: the {how} emit's .dbg differs")
    print(f"emit (host clock, in turns) {label}: " + ", ".join(
        f"{how} " + ", ".join(f"{t:.4f}" for t in ts) + " s" for how, ts in times.items())
        + "; both the slice's bytes")


NATIVE_PHASES = ("read", "emit", "emit_write", "merge", "total")
SERVE_START_S = 300  # the daemon's socket must appear within this
# what a cold process pays before the run, step by step: each a process
# that stops after its step
COLD_STEPS = (
    ("python", "pass"),
    ("+ import torch", "import torch"),
    ("+ CUDA context", "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"),
    ("+ libraries and imports",
     "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
     "from twopaco_tpu_torch.kernels import build; build.lib()\n"
     "from twopaco_tpu_torch.io import native; assert native.available()\n"
     "from twopaco_tpu_torch.cli import twopaco\n"
     "from twopaco_tpu_torch.passes import pipeline, sortpipe"),
)
SERVE_REQUEST_S = 600


def native_checks(fa, slice_run, launches, label) -> None:
    """The port's native host library (io/native.py): it must load; its
    encoder must give the numpy parser's headers and codes on the slice's
    FASTA; the CLI at sort -r 1 with it and with TWOPACO_NATIVE=0, in turns,
    and the Bloom engine at byte -f 30 with it, must write SLICE_SHA256."""
    import numpy as np

    from twopaco_tpu_torch.io import fasta, native
    from twopaco_tpu_torch.passes import bloompipe

    t0 = time.time()
    loaded = native.available()
    require(loaded, f"the native host library did not load: {native.status()}")
    print(f"native library: {native.status()} ({time.time() - t0:.3f} s to build or find "
          f"and load; g++ log beside it)")
    times, parsed = {"native": [], "numpy": []}, {}
    for how in ("native", "numpy", "numpy", "native"):
        t0 = time.time()
        if how == "native":
            parsed[how] = native.encode_fasta_native(fa)
        else:
            parsed[how] = list(fasta._parse_buffer(np.fromfile(fa, dtype=np.uint8), fa))
        times[how].append(time.time() - t0)
    nat, ref = parsed["native"], parsed["numpy"]
    require([h for h, _c in nat] == [h for h, _c in ref], "native headers != numpy headers")
    require(all(np.array_equal(a, b) for (_h, a), (_g, b) in zip(nat, ref)),
            "native codes != numpy codes")
    n_codes = sum(len(c) for _h, c in nat)
    print(f"encode the slice's FASTA ({os.path.getsize(fa)} bytes, {len(nat)} records, "
          f"{n_codes} codes): native {times['native'][0]:.4f}, {times['native'][1]:.4f} s; "
          f"numpy {times['numpy'][0]:.4f}, {times['numpy'][1]:.4f} s; equal headers and "
          f"codes (host of {label})")
    walls = {}
    for i, how in enumerate(("native", "numpy", "numpy", "native")):
        tag = f"{how}_r1_{i}"
        out = os.path.join(WORK, f"slice_{tag}.dbg")
        text, wall = slice_run(tag, ["-k", str(SLICE["k"]), "-f", "30", fa, "-o", out],
                               env={"TWOPACO_NATIVE": "0"} if how == "numpy" else None,
                               phases=NATIVE_PHASES[:-1])
        require(launches[tag].get("build_records", 0) == 1, f"{tag}: no record build")
        require(sha256(out) == SLICE_SHA256, f"{tag}: .dbg differs from SLICE_SHA256")
        walls.setdefault(how, []).append((phase_times(text), wall))
    for how, runs in walls.items():
        print(f"sort -r 1, {how} I/O (two runs, in turns) {label}: " + "; ".join(
            ", ".join(f"{n}={t[n]:.3f}" for n in NATIVE_PHASES) + f", wall={w:.3f} s"
            for t, w in runs))
    out = os.path.join(WORK, "slice_native_bloom.dbg")
    text, _wall = slice_run("native_bloom", ["--tpu-engine", "bloom", "-k", str(SLICE["k"]),
                                             "-f", "30", fa, "-o", out],
                            phases=bloompipe.PHASES)
    for name in BLOOM_PATH:
        require(launches["native_bloom"].get(name, 0) > 0, f"native_bloom: no launch of {name}")
    require("(byte layout)" in text, "native_bloom: not the byte layout")
    require(card_emit(launches["native_bloom"]), "native_bloom: the keys not written on the card")
    require(sha256(out) == SLICE_SHA256, "native_bloom: .dbg differs from SLICE_SHA256")
    print("native: every run wrote SLICE_SHA256")


def serve_checks(fa, k, label) -> None:
    """One cold CLI process on the slice, then a --device cuda daemon
    (cli/serve.py) as a child, asked through the port's tpclient: sort -r 1
    twice, graphdump -f group of the first .dbg (equal to the direct
    graphdump), bad arguments (rc 2), Bloom -f 30, sort -r 1 again; then
    __shutdown__, which must end the child with exit 0. The child is killed
    whatever happens. Also times the steps of a cold start (COLD_STEPS)."""
    import tempfile

    from twopaco_tpu_torch.cli import serve

    client = str(serve.client_path())
    argv = ["-k", str(k), "-f", "30", fa, "-o"]
    cold_out = os.path.join(WORK, "slice_cold.dbg")
    t0 = time.time()
    cold = subprocess.run([sys.executable, "-m", "twopaco_tpu_torch.cli.twopaco", *argv,
                           cold_out], cwd=ROOT, capture_output=True, text=True,
                          timeout=SERVE_REQUEST_S)
    cold_wall = time.time() - t0
    require(cold.returncode == 0, f"cold CLI process exited {cold.returncode}: "
            f"{cold.stderr[-3000:]}")
    require(sha256(cold_out) == SLICE_SHA256, "cold CLI process: .dbg differs")
    starts = {}
    for step, code in COLD_STEPS:
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=SERVE_REQUEST_S)
        require(r.returncode == 0, f"cold start step {step}: {r.stderr[-3000:]}")
        starts[step] = time.time() - t0
    cold_total = phase_times(cold.stdout)["total"]
    print(f"cold start {label}: processes that stop after each step: "
          + ", ".join(f"{step} {t:.3f} s" for step, t in starts.items())
          + f"; the cold CLI process {cold_wall:.3f} s, of which its run (time total) "
          f"{cold_total:.3f} s")
    sock_dir = tempfile.mkdtemp(prefix="tps")
    sock = os.path.join(sock_dir, "twopaco.sock")
    log_path = os.path.join(WORK, "serve.log")
    env = {v: val for v, val in os.environ.items() if v not in MODE_VARS}
    env["TWOPACO_SERVER_SOCKET"] = sock
    with open(log_path, "wb") as log:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "twopaco_tpu_torch.cli.serve", "--device", "cuda",
             "--socket", sock, "--idle-timeout", str(SERVE_REQUEST_S)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.time()
        while not os.path.exists(sock):
            if daemon.poll() is not None or time.time() - t0 > SERVE_START_S:
                with open(log_path) as f:
                    raise SmokeFailure(f"no daemon socket within {SERVE_START_S} s: {f.read()}")
            time.sleep(0.05)
        print(f"daemon: socket after {time.time() - t0:.3f} s {label}")

        def ask(tag, *args):
            t1 = time.time()
            r = subprocess.run([client, *args], cwd=WORK, env=env, capture_output=True,
                               text=True, timeout=SERVE_REQUEST_S)
            return r, time.time() - t1

        walls = []
        for tag, extra in (("served_1", []), ("served_2", []),
                           ("served_bloom", ["--tpu-engine", "bloom"]), ("served_3", [])):
            out = os.path.join(WORK, f"slice_{tag}.dbg")
            r, wall = ask(tag, "twopaco", *extra, *argv, out)
            require(r.returncode == 0, f"{tag}: rc {r.returncode}: {r.stderr[-3000:]}")
            require(sha256(out) == SLICE_SHA256, f"{tag}: .dbg differs from SLICE_SHA256")
            times = phase_times(r.stdout)
            walls.append(wall)
            print(f"{tag}: SLICE_SHA256, client wall {wall:.3f} s {label}; phases (s): "
                  + ", ".join(f"{n}={times[n]:.3f}" for n in ("read", "emit", "total")))
            if tag == "served_bloom":
                require("(byte layout)" in r.stdout, "served_bloom: not the byte layout")
            if tag == "served_2":  # graphdump, then bad arguments, between the runs
                first = os.path.join(WORK, "slice_served_1.dbg")
                r, gd_wall = ask("graphdump", "graphdump", "-f", "group", "-k", str(k), first)
                require(r.returncode == 0, f"served graphdump: rc {r.returncode}")
                require(r.stdout == graphdump_text(["-f", "group", "-k", str(k), first]),
                        "served graphdump group != the direct graphdump's")
                print(f"served graphdump -f group: {len(r.stdout)} bytes, equal to the "
                      f"direct output, client wall {gd_wall:.3f} s")
                r, _w = ask("bad", "twopaco", "--definitely-not-a-flag")
                require(r.returncode == 2, f"bad arguments answered {r.returncode}, not 2")
        r, _w = ask("shutdown", "__shutdown__")
        require(r.returncode == 0, f"__shutdown__ answered {r.returncode}")
        rc = daemon.wait(timeout=60)
        require(rc == 0, f"the daemon exited {rc} after __shutdown__")
        print(f"latency, the slice at sort -r 1 {label}: cold process {cold_wall:.3f} s "
              f"(python -m twopaco_tpu_torch.cli.twopaco); served first {walls[0]:.3f} s, "
              f"second {walls[1]:.3f} s (tpclient wall); daemon exited 0")
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        import numpy as np

        from twopaco_tpu_torch import hostmem, trace
        from twopaco_tpu_torch.io import fasta, windows
        from twopaco_tpu_torch.kernels import build
        from twopaco_tpu_torch.ops import pack
        from twopaco_tpu_torch.ops import bloom
        from twopaco_tpu_torch.parallel import distpipe, sharded, sortshard
        from twopaco_tpu_torch.parallel.mesh import LocalMesh
        from twopaco_tpu_torch.passes import (
            bloompipe, extract, fill, histogram, judge, lookup, mark, merge, occ, partition,
            records, route, shardbloom, sort, sortpipe, stream, upload, versions,
        )
        from twopaco_tpu_torch.passes.pipeline import PassConfig, PipelineConfig, RunStats
        from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted
        from twopaco_tpu_torch.testing import bench_data, judge_cases, selftest
    except ImportError as e:
        print(f"chip_smoke: the twopaco_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1

    phase("device")
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    label = f"[{card}]"
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    phase("build kernels")
    build.lib()
    secs = build.LIBRARY.build_seconds
    print("kernel build: " + (f"{secs:.1f} s (nvcc, sm_90a, one process a source; "
          "ptxas report in twopaco_tpu_torch/kernels/build/build.log)"
          if secs is not None else "reused an existing build") + f" {label}")

    phase("slice data")
    t0 = time.time()
    fa = os.path.join(WORK, "bench_8x8M.fa")
    bench_data.write_bench_fasta(fa, SLICE["n_seqs"], SLICE["length"], SLICE["seed"])
    k = SLICE["k"]
    size = os.path.getsize(fa)
    P, B = (16384, 128) if size >= (64 << 20) else (2048, 256)  # the CLI's tier
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    seqs = [(i, c) for i, _h, c in fasta.read_all_records([fa])]
    batches = list(windows.iter_window_batches(iter(seqs), cfg.window_config()))
    n_slots = len(batches) * B * P
    print(f"slice: {size} bytes, P={P} B={B}, {len(batches)} batches, "
          f"{n_slots} record slots ({time.time() - t0:.1f} s to make)")

    results: dict = {}
    launches: dict = {}  # a path's launch counts, read just after its run

    phase("upload")
    # the main path's front: the FASTA encoded into one host buffer, the
    # window rows' metadata and table (no uint8 rows), the buffer
    # page-locked for one H2D, one launch of upload.cu for every row
    t0 = time.time()
    _seqs, wrows = sortpipe.read_batches([fa], None, cfg, RunStats())
    t_read = time.time() - t0
    del _seqs
    R = wrows.row_chars
    t0 = time.time()
    with hostmem.pinned([wrows.codes], dev):
        t_lock = time.time() - t0
        t0 = time.time()
        codes_d = wrows.codes.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t_h2d = time.time() - t0
        t0 = time.time()
    t_unlock = time.time() - t0
    table_d = torch.from_numpy(wrows.table).to(dev)
    print(f"upload: read and window rows {t_read:.3f} s; {len(wrows.table)} rows of {R} chars "
          f"from {codes_d.numel()} staged bytes; page-locking them {t_lock * 1e3:.2f} ms, "
          f"their H2D {t_h2d * 1e3:.2f} ms = {codes_d.numel() / t_h2d / 1e9:.2f} GB/s, "
          f"unlocking {t_unlock * 1e3:.2f} ms {label}")
    # the same copy again, pageable and page-locked for it (lock, copy,
    # unlock) in turns: what the lock costs once the process has paid its
    # first one
    h2d = {"pageable": [], "page-locked": []}
    for how in ("pageable", "page-locked", "page-locked", "pageable"):
        torch.cuda.synchronize()
        t0 = time.time()
        with hostmem.pinned([wrows.codes] if how == "page-locked" else [], dev):
            again = wrows.codes.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        h2d[how].append(time.time() - t0)
        require(torch.equal(again, codes_d), f"upload: the {how} H2D differs")
        del again
    print("upload: the staged codes' H2D in turns (host clock): " + ", ".join(
        f"{how} " + ", ".join(f"{t * 1e3:.2f}" for t in ts) + " ms" for how, ts in h2d.items())
        + f" {label}")
    compare("upload_rows", lambda: upload.pack_rows(codes_d, table_d, R=R),
            lambda: upload.pack_rows_plain(codes_d, table_d, R=R), 5, results,
            in_bytes=nbytes(codes_d, table_d))
    got_p, got_m = (t.cpu().numpy() for t in upload.pack_rows(codes_d, table_d, R=R))
    del codes_d, table_d
    # the JAX package's host path at full size: its windows' uint8 rows
    # and pack_codes_host, batch by batch, the same words and metadata
    require(len(wrows) == len(batches), f"{len(wrows)} window batches, not {len(batches)}")
    for i, (wb, hb) in enumerate(zip(wrows, batches)):
        hp, hm = pack.pack_codes_host(hb.codes)
        require(np.array_equal(got_p[i * B : (i + 1) * B], hp)
                and np.array_equal(got_m[i * B : (i + 1) * B], hm)
                and wb.row0 == hb.row0 and all(np.array_equal(getattr(wb, f), getattr(hb, f))
                                               for f in ("seq_id", "pos0", "valid", "n_pos")),
                f"upload: batch {i} differs from the host windows and pack")
    del got_p, got_m
    print(f"upload: the kernel's {len(wrows)} batches equal the host windows and "
          f"pack_codes_host, word for word")
    uploads = sortpipe.upload_batches(wrows, dev)  # its `upload` span is a root here
    print(f"upload_batches (H2D, one launch, the batches' views): "
          f"{trace.last_build()[0].seconds:.4f} s {label}")

    phase("kernels vs plain versions")

    def upload(batch):
        p, m = pack.pack_codes_host(batch.codes)
        return [torch.from_numpy(a).to(dev) for a in (p, m, batch.valid)]

    # record build: the main path's call first (its time is the one
    # reported): the -r 1 round's table of every batch in one launch; then
    # one batch at k=25 (full gate and a narrow hash gate), one at the dist
    # append's shape (a shard's B/4 rows) and one at k=101
    bases = [b.row0 * P for b in batches]
    compare(
        "build_records",
        lambda: records.build_sort_records_batches(uploads, bases, k=k, P=P),
        lambda: records.build_sort_records_batches_plain(uploads, bases, k=k, P=P),
        2, results, in_bytes=nbytes(uploads), ops=records_ops(n_slots, len(batches) * B, k),
    )
    print(f"build_records: the -r 1 round's {len(batches)} batches in one launch")
    args = upload(batches[0])
    for low, high in ((0, 0xFFFFFFFF), (1 << 30, 3 << 30)):
        compare(
            "build_records",
            lambda: records.build_sort_records(*args, 0, k=k, P=P, low=low, high=high),
            lambda: records.build_sort_records_plain(*args, 0, k=k, P=P, low=low, high=high),
            10, results, in_bytes=nbytes(args), ops=records_ops(B * P, B, k),
        )
    args4 = [a[: B // D4] for a in args]
    compare(
        "build_records",
        lambda: records.build_sort_records(*args4, 0, k=k, P=P),
        lambda: records.build_sort_records_plain(*args4, 0, k=k, P=P),
        50, results, in_bytes=nbytes(args4), ops=records_ops(B // D4 * P, B // D4, k),
    )
    print(f"build_records: one batch of the dist append's shape ({B // D4} rows), "
          f"{results['build_records'][-1]['ms']:.4f} ms event time {label}")
    cfg101 = PipelineConfig(k=101, positions_per_row=P, rows_per_batch=B)
    b101 = next(windows.iter_window_batches(iter(seqs), cfg101.window_config()))
    args101 = upload(b101)
    compare(
        "build_records_k101",
        lambda: records.build_sort_records(*args101, 0, k=101, P=P),
        lambda: records.build_sort_records_plain(*args101, 0, k=101, P=P),
        5, results, in_bytes=nbytes(args101), ops=records_ops(B * P, B, 101),
    )
    # the slice's whole round buffer, built as the main path builds it
    w = cfg.w
    buf = records.build_sort_records_batches(uploads, bases, k=k, P=P)
    torch.cuda.synchronize()
    # the library call: a stable torch.sort of the records' packed u64 keys
    # (w = 2 words, made signed-order), then the three gathers
    key = ((pack.as_i64(buf[0][:, 0]) - (1 << 31)) << 32) | pack.as_i64(buf[0][:, 1])

    def sort_library():
        order = torch.sort(key, stable=True).indices
        return (buf[0].view(torch.int32).index_select(0, order),
                buf[1].view(torch.int32).index_select(0, order), buf[2].index_select(0, order))

    compare("sort_records", lambda: sort.sort_records(*buf, key_bits=2 * k),
            lambda: sort.sort_records_plain(*buf, key_bits=2 * k), 3, results,
            in_bytes=nbytes(buf), library=sort_library if w == 2 else None)
    del key
    srt = sort.sort_records(*buf, key_bits=2 * k)
    del buf
    for ab in (judge.NO_ABUNDANCE, 4):
        # the bound reads every record's words and payload, and the
        # position of the kept rows only (8 bytes an occurrence)
        n_occ = judge.judge_compact(*srt, ab)[5]
        compare(
            "judge_compact",
            lambda: judge.judge_compact(*srt, ab),
            lambda: judge.judge_compact_plain(*srt, ab),
            3, results, in_bytes=nbytes(srt[:2]) + 8 * n_occ,
        )
    for ab in (judge.NO_ABUNDANCE, 3):
        exact("judge_records", lambda: judge.judge_records(*srt[:2], ab),
              lambda: judge.judge_records_plain(*srt[:2], ab), results,
              f"the slice's round, abundance {'none' if ab == judge.NO_ABUNDANCE else ab}")
    slice_table, slice_occ_pos, slice_occ_id = (
        t.clone() for t in judge.judge_compact(*srt)[:3])  # Bloom lookup, occurrence sort
    del srt
    # the judge's edge inputs (testing/judge_cases.py), both entries
    for case in judge_cases.CASES:
        jw, jp, jpos = (torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
                        .to(dev) for a in judge_cases.make(case, seed=len(case)))
        jw, jp = pack.as_u32(jw), pack.as_u32(jp)
        for ab in (judge.NO_ABUNDANCE, 3):
            tag = f"{case} ({jw.shape[0]} x {jw.shape[1]}), abundance " + (
                "none" if ab == judge.NO_ABUNDANCE else str(ab))
            exact("judge_compact", lambda: judge.judge_compact(jw, jp, jpos, ab),
                  lambda: judge.judge_compact_plain(jw, jp, jpos, ab), results, tag)
            exact("judge_records", lambda: judge.judge_records(jw, jp, ab),
                  lambda: judge.judge_records_plain(jw, jp, ab), results, tag)
        if case == "long_group":
            judge_once = (jw, jp, jpos)  # for the device kernels of one call
        del jw, jp, jpos
    torch.cuda.synchronize()
    # the slice's round buffer at k = 101 (w = 7: a digit-pass group a
    # word, the last cut to its 10 k-mer bits, and the final gather)
    batches101 = list(windows.iter_window_batches(iter(seqs), cfg101.window_config()))
    n101 = len(batches101) * B * P
    buf101 = (torch.empty((n101, cfg101.w), dtype=torch.uint32, device=dev),
              torch.empty(n101, dtype=torch.uint32, device=dev),
              torch.empty(n101, dtype=torch.int64, device=dev))
    for b in batches101:
        off = b.row0 * P
        records.build_sort_records(*upload(b), off, k=101, P=P,
                                   out=tuple(t[off : off + B * P] for t in buf101))
    del batches101
    compare("sort_records_k101", lambda: sort.sort_records(*buf101, key_bits=202),
            lambda: sort.sort_records_plain(*buf101, key_bits=202), 3, results,
            in_bytes=nbytes(buf101))
    print(f"sort_records_k101: the slice's k = 101 round, {n101} records of {cfg101.w} words")
    del buf101
    torch.cuda.synchronize()

    phase(f"multi-round kernels vs plain versions (-r {ROUNDS} shapes)")
    bp = B * P
    hist_stride = max(1, 1 << max(0, n_slots.bit_length() - 24))  # as the path
    # histogram: the path's call first (its time is the one reported): one
    # launch over the run's batches at the path's stride; then one batch
    rows_h = max(B // hist_stride, 1)
    compare(
        "histogram",
        lambda: histogram.histogram_vertex_hashes_batches(uploads, k=k, P=P, stride=hist_stride),
        lambda: histogram.histogram_vertex_hashes_batches_plain(uploads, k=k, P=P,
                                                                stride=hist_stride),
        5, results, in_bytes=nbytes([[a[:rows_h] for a in u] for u in uploads]),
        ops=hist_ops(len(uploads) * rows_h * P, len(uploads) * rows_h, k, word0=False),
    )
    for stride in (hist_stride, 1):
        rows_s = max(B // stride, 1)
        compare(
            "histogram",
            lambda: histogram.histogram_vertex_hashes(*args, k=k, P=P, stride=stride),
            lambda: histogram.histogram_vertex_hashes_plain(*args, k=k, P=P, stride=stride),
            10, results, in_bytes=nbytes([a[:rows_s] for a in args]),
            ops=hist_ops(rows_s * P, rows_s, k, word0=False),
        )
    hist_k = histogram.histogram_scan(uploads, k=k, P=P, stride=hist_stride)
    hist_p = histogram.histogram_scan(
        uploads, k=k, P=P, stride=hist_stride,
        fn=histogram.histogram_vertex_hashes_batches_plain)
    require(np.array_equal(hist_k, hist_p), "histogram scan differs from the plain one")
    print(f"histogram scan of {len(uploads)} batches at stride {hist_stride}: exact")
    # resident partition into the path's blocks: 4 rounds, cap 1.25 B*P / 4;
    # the main path's call first (its time is the one reported): the pass's
    # batches in one call over their table, then one batch
    intervals = sortpipe._live_intervals(np.ones(1 << 16, np.int64), ROUNDS)
    highs = [h for _l, h in intervals]
    part_cap = -(-int(cfg.round_slack * bp) // len(intervals))
    highs_d = pack.as_u32(torch.tensor(highs, dtype=torch.int64, device=dev))

    def scan_out(res):
        return (*res[:3], torch.from_numpy(res[3]))

    build.reset_launch_counts()
    *blocks, counts = partition.partition_scan(
        uploads, highs, 0, 0xFFFFFFFF, k=k, P=P, part_cap=part_cap)
    require(build.launch_counts() == {"partition": 1},
            f"partition scan: {build.launch_counts()}, not one call")
    require((counts <= part_cap).all(), "partition scan: a block overflowed")
    # the bound: the uploads read once, every block slot written once
    compare(
        "partition",
        lambda: scan_out(partition.partition_scan(uploads, highs, 0, 0xFFFFFFFF, k=k, P=P,
                                                  part_cap=part_cap)),
        lambda: scan_out(partition.partition_scan_plain(uploads, highs, 0, 0xFFFFFFFF, k=k,
                                                        P=P, part_cap=part_cap)),
        2, results, in_bytes=nbytes(uploads, highs_d), out_bytes=nbytes(blocks),
        ops=records_ops(n_slots, len(batches) * B, k),
    )
    print(f"partition scan: the pass's {len(uploads)} batches in one call, blocks "
          f"{tuple(blocks[0].shape)} exact ({nbytes(blocks) / 1e9:.2f} GB)")
    compare(
        "partition",
        lambda: partition.partition_batch(*args, highs_d, 0, 0xFFFFFFFF, k=k, P=P,
                                          part_cap=part_cap),
        lambda: partition.partition_batch_plain(*args, highs_d, 0, 0xFFFFFFFF, k=k,
                                                P=P, part_cap=part_cap),
        5, results, in_bytes=nbytes(args, highs_d), ops=records_ops(B * P, B, k),
    )
    bases_d = torch.tensor(bases, dtype=torch.int64, device=dev)
    asm_slots = len(batches) * part_cap
    for r in range(len(intervals)):
        compare(
            "assemble",
            lambda: partition.assemble_round(r, *blocks, bases_d, asm_slots),
            lambda: partition.assemble_round_plain(r, *blocks, bases_d, asm_slots),
            5 if r == 0 else 1, results,
            in_bytes=int(counts[:, r].sum()) * sortpipe.block_bytes(w) + nbytes(bases_d),
        )
    del blocks
    # stream compaction: one batch's round-0 records appended, then a
    # whole round against the plain compaction
    low, high = intervals[0]
    st_slots = -(-int(n_slots * cfg.round_slack) // len(intervals)) + bp
    recs = records.build_sort_records(*args, 0, k=k, P=P, low=low, high=high)
    (buf_k, st_k), (buf_p, st_p) = (stream.new_round_buffer(st_slots, w, dev) for _ in "kp")
    compare(
        "compact",
        lambda: (st_k.zero_(), stream.compact_append(*recs, buf_k, st_k, st_slots - bp),
                 *buf_k, st_k)[2:],
        lambda: (st_p.zero_(), stream.compact_append_plain(*recs, buf_p, st_p, st_slots - bp),
                 *buf_p, st_p)[2:],
        10, results, in_bytes=nbytes(recs),
        out_bytes=int((pack.as_i64(recs[1]) >> 17 & 1).sum()) * (4 * w + 12) + nbytes(st_k),
    )
    del buf_k, buf_p
    # four batches' records in one append (2048 look-back tiles, a quarter
    # of the rows real); then the same at an offset whose append passes lim
    # (the overflow flag set) and at one past lim (the write clamped)
    recs4b = records.build_sort_records_batches(uploads[:4], [0, bp, 2 * bp, 3 * bp], k=k, P=P,
                                                low=low, high=high)
    n4, cnt4 = 4 * bp, int((pack.as_i64(recs4b[1]) >> 17 & 1).sum())
    lim4 = 2 * n4 - n4
    for what, off0 in (("many tiles", 5), ("overflow", lim4 - cnt4 // 2), ("clamp", lim4 + 3)):
        (buf_k, st_k), (buf_p, st_p) = (stream.new_round_buffer(2 * n4, w, dev) for _ in "kp")
        compare(
            "compact",
            lambda: (st_k.copy_(torch.tensor([off0, 0])),
                     stream.compact_append(*recs4b, buf_k, st_k, lim4), *buf_k, st_k)[2:],
            lambda: (st_p.copy_(torch.tensor([off0, 0])),
                     stream.compact_append_plain(*recs4b, buf_p, st_p, lim4), *buf_p, st_p)[2:],
            3, results, in_bytes=nbytes(recs4b), out_bytes=nbytes(recs4b) + nbytes(st_k),
        )
        require(st_k.tolist() == [min(off0, lim4) + cnt4, int(what != "many tiles")],
                f"compact {what}: state {st_k.tolist()}")
        print(f"compact {what}: {n4} records ({cnt4} real) at offset {off0}, lim {lim4}: "
              f"exact, state {st_k.tolist()}")
        del buf_k, buf_p
    del recs4b
    rounds = [
        stream.stream_round(uploads, bases, low, high, k=k, P=P, buf_slots=st_slots,
                            compact_fn=fn)
        for fn in (stream.compact_append, stream.compact_append_plain)
    ]
    err = max_abs_err(*rounds)
    require(err == 0 and not rounds[0][3], f"stream round differs or overflows ({err})")
    print(f"stream round 0: buffer of {st_slots} slots exact, no overflow")
    del rounds, recs
    torch.cuda.synchronize()

    phase(f"distributed kernels vs plain versions (D={D4} shapes)")
    mesh4 = LocalMesh([torch.device("cuda", 0)] * D4)
    _n_rounds4, route_cap = distpipe.plan_dist(cfg, mesh4, n_slots, None)
    # the slice's word0 histogram, as the path measures it (one launch a
    # shard over its resident batches), for the bounds; shard 0's first
    # (its time is the one reported)
    shard0 = [tuple(a[: B // D4] for a in u) for u in uploads]
    compare("word0_histogram",
            lambda: histogram.word0_histogram_batches(shard0, k=k, P=P),
            lambda: histogram.word0_histogram_batches_plain(shard0, k=k, P=P), 5, results,
            in_bytes=nbytes(shard0),
            ops=hist_ops(len(shard0) * (B // D4) * P, len(shard0) * (B // D4), k, word0=True))
    print(f"word0_histogram: shard 0's {len(shard0)} batches in one launch")
    whist = histogram.word0_histogram_batches(uploads, k=k, P=P)
    bounds = distpipe.route_bounds_from_hist(whist.cpu().numpy().astype(np.int64), D4)
    bounds_d = pack.as_u32(torch.from_numpy(bounds.astype(np.int64)).to(dev))
    print(f"word0 bounds of the slice: {bounds.tolist()}, route cap {route_cap}")
    del uploads, whist, shard0
    # batch 0, shard 0's rows: B/D rows at base 0
    recs4 = records.build_sort_records(*(a[: B // D4] for a in args), 0, k=k, P=P)
    # into send buffers allocated once, as the append loop routes
    send_k, send_p = (route.new_send(D4, route_cap, w, dev) for _ in "kp")
    for bnd in (bounds_d, None):
        compare("route",
                lambda: route.route_records(*recs4, D4, route_cap, bounds=bnd, out=send_k),
                lambda: route.route_records_plain(*recs4, D4, route_cap, bounds=bnd,
                                                  out=send_p),
                10, results, in_bytes=nbytes(recs4, bnd))
    # one call, for the device kernels listed with the dist-bloom bucket's
    route_once = lambda: route.route_records(*recs4, D4, route_cap,  # noqa: E731
                                             bounds=bounds_d, out=send_k)
    del send_p
    sent = route.route_records(*recs4, D4, route_cap, bounds=bounds_d)
    require(int(sent[3]) == 0, "route: the slice's shard overflowed its cap")
    print("route: per-shard records of batch 0, shard 0: "
          f"{[int(x) for x in (pack.as_i64(sent[1]) >> 17 & 1).sum(dim=1)]}")
    del sent
    # one batch in one call
    compare("word0_histogram",
            lambda: histogram.word0_histogram(*args, k=k, P=P),
            lambda: histogram.word0_histogram_plain(*args, k=k, P=P), 10, results,
            in_bytes=nbytes(args), ops=hist_ops(B * P, B, k, word0=True))
    # a batch of the slice's shapes whose rows are the first B/8 rows of
    # each genome (a slice batch holds one genome: no junction in it)
    mix = next(windows.iter_window_batches(
        iter([(i, c[: B // len(seqs) * P]) for i, c in seqs]), cfg.window_config()))
    args_mix = upload(mix)
    bsrt = sort.sort_records(*records.build_sort_records(*args_mix, 0, k=k, P=P),
                             key_bits=2 * k)
    compare("judge_records", lambda: judge.judge_records(*bsrt[:2]),
            lambda: judge.judge_records_plain(*bsrt[:2]), 10, results,
            in_bytes=nbytes(bsrt[:2]))
    # the library call: torch.sort of the occurrences' int64 merge keys
    okey = (slice_occ_pos << 32) | (slice_occ_id.to(torch.int64) + (1 << 31))
    compare("sort_occurrences",
            lambda: occ.sort_occurrences(slice_occ_pos, slice_occ_id, id_bits=32,
                                         pos_limit=n_slots),
            lambda: occ.sort_occurrences_plain(slice_occ_pos, slice_occ_id, id_bits=32,
                                               pos_limit=n_slots),
            5, results, in_bytes=nbytes(slice_occ_pos, slice_occ_id),
            library=lambda: torch.sort(okey))
    del okey
    print(f"sort_occurrences: the -r 1 round's {slice_occ_pos.shape[0]} occurrences")
    del slice_occ_pos, slice_occ_id

    phase(f"sharded_sort_step on one batch of the 8 genomes ({D4} shards of the card)")
    p0, m0 = pack.pack_codes_host(mix.codes)
    parts = [mesh4.put_rows(a) for a in (p0, m0, mix.valid)]
    batch4 = {s: tuple(x[s] for x in parts) for s in mesh4.shards}
    scfg4 = sortshard.SortShardConfig(base=PassConfig(k=k, positions_per_row=P,
                                                      rows_per_batch=B), n_shards=D4)
    step = sortshard.sharded_sort_step(mesh4, scfg4)
    build.reset_launch_counts()
    blocks, nj4, no4, over4 = step(batch4, 0, 0xFFFFFFFF, judge.NO_ABUNDANCE)
    torch.cuda.synchronize()
    launches["step"] = build.launch_counts()
    print(f"step: launches {launches['step']}")
    for name in ("build_records", "route", "sort_records", "judge_records"):
        require(launches["step"].get(name, 0) > 0, f"step: no launch of {name}")
    kf1, keep1, ids1, _g1, nj1, no1 = judge.judge_records(*bsrt[:2])
    require(over4 == 0 and (nj4, no4) == (nj1, no1) and nj1 > 0,
            f"step counts {(nj4, no4, over4)} != one shard's {(nj1, no1, 0)}")
    table4 = torch.cat([pack.take_u32(sw, kf.nonzero().squeeze(1))
                        for sw, _p, kf, _g in blocks.values()])
    table1 = pack.take_u32(bsrt[0], kf1.nonzero().squeeze(1))
    require(max_abs_err([table4], [table1]) == 0, "step: table differs from one shard's")
    occ4 = torch.cat([torch.stack([p[g != 0], g[g != 0]]) for _w, p, _k, g in blocks.values()],
                     dim=1)
    occ1 = torch.stack([bsrt[2][keep1], ids1[keep1].to(torch.int64)])
    o4, o1 = (o[:, torch.sort(o[0]).indices] for o in (occ4, occ1))
    require(torch.equal(o4, o1), "step: occurrences differ from one shard's")
    print(f"step: {nj4} junctions, {no4} occurrences, no overflow; table and "
          f"occurrences equal the one-shard sort + judge_records")
    del blocks, bsrt, batch4, parts, args_mix
    torch.cuda.synchronize()

    phase("golden sha256 (JAX package outputs)")
    with open(GOLDEN) as f:
        golden = json.load(f)
    for name, spec in golden.items():
        srcs = []
        for i, src in enumerate(spec["input"] if isinstance(spec["input"], list)
                                else [spec["input"]]):
            if src.startswith("bench:"):
                n, length, seed = (int(x) for x in src[6:].split(":"))
                src = bench_data.write_bench_fasta(
                    os.path.join(WORK, f"{name}_{i}.fa"), n, length, seed)
            else:
                src = os.path.join(ROOT, src)
            srcs.append(src)
        out = os.path.join(WORK, f"{name}.dbg")
        run_cli(["-k", str(spec["k"]), "-f", "20", *srcs, "-o", out])
        got = sha256(out)
        require(got == spec["sha256"], f"{name}: .dbg sha256 {got} != {spec['sha256']}")
        print(f"golden {name}: sha256 matches the JAX package")
    torch.cuda.synchronize()

    phase("graphdump of the card's k = 101 .dbg; the self test on the card")
    lk = golden["largek_k101"]
    lk_fa = os.path.join(ROOT, lk["input"])
    lk_dbg = os.path.join(WORK, "largek_k101.dbg")
    gold = os.path.join(ROOT, "tests", "golden", "largek_k101.")
    t0 = time.time()
    text = graphdump_text(["-f", "group", "-k", "101", lk_dbg])
    with open(gold + "group") as f:
        require(text == f.read(), "graphdump group of the card's .dbg != the reference's")
    text = graphdump_text(["-f", "gfa1", "-k", "101", "-s", lk_fa, lk_dbg])
    with open(gold + "gfa1") as f:
        want = f.read()
    kinds = [collections.Counter(line.split("\t")[0] for line in t.splitlines())
             for t in (text, want)]
    require(kinds[0] == kinds[1],
            f"graphdump gfa1 records {kinds[0]} != the reference's {kinds[1]}")
    gfa_spells_back(text, lk_fa, lk["k"])
    print(f"graphdump of the card's k = 101 .dbg: group equals the reference graphdump's "
          f"bytes; gfa1 has its records {dict(kinds[0])} and spells every input sequence "
          f"({time.time() - t0:.2f} s)")
    t0 = time.time()
    require(selftest.run_tests(tests=1, length=400, chr_number=2, k_values=(5,),
                               rounds_values=(1, 2), seed=11, device=dev),
            "the self test failed on the card")
    print(f"self test (sort and Bloom engines, k = 5, -r 1 and 2) on the card: passed "
          f"({time.time() - t0:.2f} s)")

    bases_n = SLICE["n_seqs"] * SLICE["length"]

    def slice_run(tag, argv, env=None, phases=sortpipe.PHASES):
        """One CLI run of the slice with the counters zeroed just before
        and read just after -> (text, wall seconds)."""
        build.reset_launch_counts()
        t0 = time.time()
        text = run_cli(argv, env, echo=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[tag] = build.launch_counts()
        times = phase_times(text)
        print(f"{tag}: launches {launches[tag]}")
        print(f"{tag} phases (s) {label}: " + ", ".join(
            f"{n}={times[n]:.3f}" for n in (*phases, "total")))
        for line in text.splitlines():
            if line.startswith("Splitting") or (
                    line.startswith("Round ") and "seconds" in line):
                print(f"{tag}   {line}")
        print(f"{tag}: {bases_n} bases in {wall:.3f} s wall = "
              f"{bases_n / wall / 1e6:.2f} Mbases/s {label}")
        return text, wall

    phase("slice: port CLI on the 8 x 8 Mbase input")
    out = os.path.join(WORK, "slice.dbg")
    slice_run("r1", ["-k", str(k), "-f", "30", fa, "-o", out])
    for name in ("build_records", "sort_records", "judge_compact", "sort_occurrences"):
        require(launches["r1"].get(name, 0) > 0, f"{name}: no launch in the slice run")
    require(launches["r1"]["build_records"] == 1,
            f"r1: {launches['r1']['build_records']} build_records launches, not one a round")
    # one launch packs every row; one round's entry needs no merge and is
    # written on the card
    require(launches["r1"].get("upload_rows") == 1 and not any(
        n in launches["r1"] for n in MERGE_PATH) and card_emit(launches["r1"]),
            f"r1: upload, merge or emit launches wrong")
    slice_sha = sha256(out)
    size_dbg = os.path.getsize(out)
    require(size_dbg > 0 and size_dbg % 12 == 0, f"slice .dbg has {size_dbg} bytes")
    require(slice_sha == SLICE_SHA256, f"slice .dbg sha256 {slice_sha} != {SLICE_SHA256}")

    phase("slice: plain versions on the card")
    out_ref = os.path.join(WORK, "slice_plain.dbg")
    t0 = time.time()
    build_junctions_sorted([fa], cfg, out_ref, device=dev, reference=True)
    torch.cuda.synchronize()
    print(f"plain-version slice run: {time.time() - t0:.3f} s wall {label}")
    require(sha256(out_ref) == slice_sha, "slice .dbg differs between kernels and plain versions")
    print(f"slice .dbg: {size_dbg} bytes, sha256 {slice_sha}, identical to the plain run")

    phase(f"slice: -r {ROUNDS} in each multi-round mode")
    resident_bytes = int(n_slots * cfg.round_slack * sortpipe.block_bytes(w))
    modes = {
        "resident": ({}, ("partition", "assemble"), "resident parts"),
        "grouped": ({"TWOPACO_RESIDENT_BYTES": str(resident_bytes // 2 + 1)},
                    ("partition", "assemble"), "in 2 resident groups"),
        "stream": ({"TWOPACO_RESIDENT": "0", "TWOPACO_GROUPED": "0"},
                   ("build_records", "compact"), f"({ROUNDS} rounds)"),
        "histogram": ({"TWOPACO_UNIFORM_SPLIT": "0"},
                      ("histogram", "partition", "assemble"), "resident parts"),
    }
    sort_r4 = {}
    for tag, (env, kernels, split_line) in modes.items():
        out_r = os.path.join(WORK, f"slice_r{ROUNDS}_{tag}.dbg")
        with capture_merge(sort_r4 if tag == "resident" else {}):
            text, _wall = slice_run(tag, ["-k", str(k), "-f", "30", "-r", str(ROUNDS), fa,
                                          "-o", out_r], env)
        for name in (*kernels, "sort_records", "judge_compact"):
            require(launches[tag].get(name, 0) > 0, f"{tag}: no launch of {name}")
        # the rounds' keyed entries merge on the card, one call each, and
        # the merged keys are written there
        require(launches[tag].get("upload_rows") == 1 and all(
            launches[tag].get(n) == 1 for n in MERGE_PATH) and card_emit(launches[tag]),
            f"{tag}: upload, merge or emit launches")
        require(launches[tag].get("histogram", 1) == 1, f"{tag}: not one histogram launch")
        # one partition call a pass: the run's, or one a group of rounds
        require(launches[tag].get("partition", 0) == {"grouped": 2, "stream": 0}.get(tag, 1),
                f"{tag}: {launches[tag].get('partition', 0)} partition calls")
        require(any(line.startswith("Splitting") and split_line in line
                    for line in text.splitlines()), f"{tag}: the mode did not run")
        require(sum(line.startswith("Round ") and "seconds" in line
                    for line in text.splitlines()) == ROUNDS, f"{tag}: not {ROUNDS} rounds")
        got = sha256(out_r)
        require(got == slice_sha, f"{tag}: -r {ROUNDS} .dbg sha256 {got} != {slice_sha}")
        print(f"{tag}: .dbg identical to the -r 1 run")

    phase(f"slice: -r {ROUNDS} resident through the plain versions on the card")
    out_ref = os.path.join(WORK, f"slice_r{ROUNDS}_plain.dbg")
    t0 = time.time()
    build_junctions_sorted([fa], PipelineConfig(k=k, rounds=ROUNDS, positions_per_row=P,
                                                rows_per_batch=B),
                           out_ref, device=dev, reference=True)
    torch.cuda.synchronize()
    print(f"plain-version -r {ROUNDS} run: {time.time() - t0:.3f} s wall {label}")
    require(sha256(out_ref) == slice_sha, f"-r {ROUNDS} plain run .dbg differs")

    phase("Bloom kernels vs plain versions (the slice's round, then one batch)")
    bcfgs = {
        "byte": PassConfig(k=k, f=30, layout="byte", positions_per_row=P, rows_per_batch=B),
        "bit": PassConfig(k=k, f=34, layout="bit", positions_per_row=P, rows_per_batch=B),
        "block": PassConfig(k=k, f=30, layout="block", positions_per_row=P, rows_per_batch=B),
    }
    full = (0, 0xFFFFFFFF)
    uploads = sortpipe.upload_batches(wrows, dev)
    round_cands = {}  # a layout's candidates in the round mark, for its engine run
    for lay, bcfg in bcfgs.items():
        filt_k = bloom.make_filter(bcfg.f, lay, dev)
        filt_p = bloom.make_filter(bcfg.f, lay, dev)
        nt = len(fill.tables(bcfg))
        # the main path's calls first (their times are the ones reported):
        # the round's fill of every batch in one launch, each repeat into a
        # zeroed filter (the zeroing untimed), then its mark
        # bounds: each distinct filter sector touched counts once; the
        # fill, into a zeroed filter, reads and writes each sector it sets
        n_fill = count_sectors(lambda fl, u: fill_sectors(fl, u, full, bcfg), filt_k, uploads)
        compare("bloom_fill",
                lambda: (fill.bloom_fill_batches(filt_k, uploads, *full, cfg=bcfg),),
                lambda: (fill.bloom_fill_batches_plain(filt_p, uploads, *full, cfg=bcfg),),
                2, results, in_bytes=nbytes(uploads) + n_fill * SECTOR,
                out_bytes=n_fill * SECTOR, ops=bloom_ops(n_slots, k, nt, bcfg.q, 1),
                prepare=(filt_k.zero_, filt_p.zero_))
        # each filled from zero by its last timed repeat
        require(torch.equal(filt_k.view(torch.uint8), filt_p.view(torch.uint8)),
                f"Bloom {lay}: the round fill's filter differs from the plain fill's")
        n_reads = count_sectors(lambda fl, u: mark_sectors(fl, filt_k, u, full, bcfg), filt_k,
                                uploads)
        compare("bloom_mark",
                lambda: flat(mark.bloom_mark_batches(filt_k, uploads, *full, cfg=bcfg)),
                lambda: flat(mark.bloom_mark_batches_plain(filt_k, uploads, *full, cfg=bcfg)),
                2, results, in_bytes=nbytes(uploads) + n_reads * SECTOR,
                ops=bloom_ops(n_slots, k, nt, bcfg.q, 6))
        _m, rcounts = mark.bloom_mark_batches(filt_k, uploads, *full, cfg=bcfg)
        round_cands[lay] = int(rcounts.sum())
        if lay == "byte":
            round_masks = _m  # pass 4's masks of a one-round run
        print(f"Bloom {lay} f={bcfg.f} round: {len(uploads)} batches in one launch each; "
              f"{n_fill} filter sectors set by the fill, {n_reads} read by the mark, of "
              f"{nbytes(filt_k) // SECTOR}; {int(rcounts.sum())} candidates of {n_slots} "
              f"positions {label}")
        del _m, rcounts
        # one batch (batch 0), against the whole slice's filter, which
        # holds its every slot: the fill reads its sectors and changes none
        # (OR is idempotent: every repeat leaves the same filter)
        compare("bloom_fill",
                lambda: (fill.bloom_fill(filt_k, *args, *full, cfg=bcfg),),
                lambda: (fill.bloom_fill_plain(filt_p, *args, *full, cfg=bcfg),),
                5, results, out_bytes=0, in_bytes=nbytes(args) + SECTOR * count_sectors(
                    lambda fl, u: fill_sectors(fl, u, full, bcfg), filt_k, [args]),
                ops=bloom_ops(B * P, k, nt, bcfg.q, 1))
        del filt_p
        compare("bloom_mark",
                lambda: mark.bloom_mark(filt_k, *args, *full, cfg=bcfg),
                lambda: mark.bloom_mark_plain(filt_k, *args, *full, cfg=bcfg),
                5, results, in_bytes=nbytes(args) + SECTOR * count_sectors(
                    lambda fl, u: mark_sectors(fl, filt_k, u, full, bcfg), filt_k, [args]),
                ops=bloom_ops(B * P, k, nt, bcfg.q, 6))
        bmask, bcount = mark.bloom_mark(filt_k, *args, *full, cfg=bcfg)
        print(f"Bloom {lay} f={bcfg.f}: filter {filt_k.numel() * filt_k.element_size()} "
              f"bytes, batch 0: {int(bcount)} candidates of {B * P} positions")
        if lay == "byte":
            mask0, count0 = bmask, int(bcount)
        del filt_k, bmask
    # the extract: the main path's call first (its time is the one reported),
    # the round's batches and byte masks in one call; the bound reads the
    # uploads' words and the masks once and writes the records
    n_cand = round_cands["byte"]
    (buf_k, st_k), (buf_p, st_p) = (extract.new_buffer(n_cand, w, dev) for _ in "kp")
    compare(
        "bloom_extract",
        lambda: (st_k.zero_(), extract.extract_records_batches(uploads, round_masks, buf_k, st_k,
                                                               bases, k=k, P=P), *buf_k,
                 st_k)[2:],
        lambda: (st_p.zero_(), extract.extract_records_batches_plain(uploads, round_masks, buf_p,
                                                                     st_p, bases, k=k, P=P),
                 *buf_p, st_p)[2:],
        3, results, in_bytes=nbytes([u[:2] for u in uploads], round_masks),
        out_bytes=n_cand * (4 * w + 12), ops=n_cand * 6 * k,
    )
    require(st_k.tolist() == [n_cand, 0], f"extract state of the round {st_k.tolist()}")
    print(f"extract of the round's {len(uploads)} batches in one call: {n_cand} records "
          f"{label}")
    del buf_k, buf_p
    (buf_k, st_k), (buf_p, st_p) = (extract.new_buffer(count0, w, dev) for _ in "kp")
    compare(
        "bloom_extract",
        lambda: (st_k.zero_(), extract.extract_records(args[0], args[1], mask0, buf_k, st_k, 0,
                                                       k=k, P=P), *buf_k, st_k)[2:],
        lambda: (st_p.zero_(), extract.extract_records_plain(args[0], args[1], mask0, buf_p,
                                                             st_p, 0, k=k, P=P),
                 *buf_p, st_p)[2:],
        10, results, in_bytes=nbytes(args[:2], mask0), out_bytes=count0 * (4 * w + 12),
        ops=count0 * 6 * k,
    )
    require(st_k.tolist() == [count0, 0], f"extract state {st_k.tolist()}")
    del buf_k, buf_p
    # the lookup: the main path's call first (its time is the one reported),
    # the round's batches and byte masks in one call; the bound reads the
    # uploads and the masks once (a candidate's key is built from its upload
    # words) and each distinct 32-byte sector of the junction table that the
    # searches touch, once, and writes the outputs (an 8-byte key a slot)
    n_tab = count_sectors(lambda fl, um: lookup_sectors(fl, *um, slice_table, k, P),
                          slice_table, list(zip(uploads, round_masks)))
    compare(
        "bloom_lookup",
        lambda: lookup.pass4_lookup_batches(uploads, round_masks, slice_table, n_cand, bases,
                                            k=k, P=P, id_bits=32),
        lambda: lookup.pass4_lookup_batches_plain(uploads, round_masks, slice_table, n_cand,
                                                  bases, k=k, P=P, id_bits=32),
        3, results, in_bytes=nbytes(uploads, round_masks) + n_tab * SECTOR,
        ops=n_cand * 6 * k,
    )
    n_run = int(lookup.pass4_lookup_batches(uploads, round_masks, slice_table, n_cand, bases,
                                            k=k, P=P, id_bits=32)[1])
    require(0 < n_run <= n_cand, f"lookup of the round: {n_run} hits of {n_cand} candidates")
    print(f"lookup of the round's {len(uploads)} batches in one call: {n_run} of {n_cand} "
          f"candidates found; {n_tab} junction-table sectors searched of "
          f"{-(-nbytes(slice_table) // SECTOR)} {label}")
    n_tab0 = count_sectors(lambda fl, um: lookup_sectors(fl, *um, slice_table, k, P),
                           slice_table, [(args, mask0)])
    compare(
        "bloom_lookup",
        lambda: lookup.pass4_lookup(*args, mask0, slice_table, count0, k=k, P=P, id_bits=32),
        lambda: lookup.pass4_lookup_batches_plain([args], [mask0], slice_table, count0, [0],
                                                  k=k, P=P, id_bits=32),
        10, results, in_bytes=nbytes(args, mask0) + n_tab0 * SECTOR,
        ops=count0 * 6 * k,
    )
    n_hit = int(lookup.pass4_lookup(*args, mask0, slice_table, count0, k=k, P=P,
                                    id_bits=32)[1])
    require(n_hit > 0, "lookup found no junction in the first batch")
    print(f"lookup: {n_hit} of {count0} candidates found among "
          f"{slice_table.shape[0]} junctions")
    torch.cuda.synchronize()

    phase("slice: the Bloom engine (--tpu-engine bloom)")
    for tag, (flags, layout) in BLOOM_RUNS.items():
        out_b = os.path.join(WORK, f"slice_{tag}.dbg")
        text, _wall = slice_run(tag, ["--tpu-engine", "bloom", "-k", str(k), *flags, fa,
                                      "-o", out_b], phases=bloompipe.PHASES)
        for name in BLOOM_PATH:
            require(launches[tag].get(name, 0) > 0, f"{tag}: no launch of {name}")
        require(launches[tag]["upload_rows"] == 1, f"{tag}: not one upload launch")
        require(f"({layout} layout)" in text, f"{tag}: not the {layout} layout")
        n_rounds = ROUNDS if "-r" in flags else 1
        for name in ("bloom_fill", "bloom_mark", "bloom_extract"):
            require(launches[tag][name] == n_rounds,
                    f"{tag}: {launches[tag][name]} {name} calls, not one a round")
        require(launches[tag]["bloom_lookup"] == 1,
                f"{tag}: {launches[tag]['bloom_lookup']} lookup calls, not one a run")
        require(card_emit(launches[tag]), f"{tag}: the keys not written on the card")
        require(sum(line.startswith("Round ") and "seconds" in line
                    for line in text.splitlines()) == n_rounds, f"{tag}: not {n_rounds} rounds")
        for line in text.splitlines():
            if line.startswith(("Candidate marks", "False junctions")):
                print(f"{tag}   {line}")
        if n_rounds == 1:  # the same layout and f as the round mark above
            cands = [int(line.rsplit("=", 1)[1]) for line in text.splitlines()
                     if line.startswith("Candidate marks count")]
            require(cands == [round_cands[layout]],
                    f"{tag}: the engine's candidates {cands} != the round mark's "
                    f"{round_cands[layout]}")
        got = sha256(out_b)
        require(got == slice_sha, f"{tag}: .dbg sha256 {got} != {slice_sha}")
        print(f"{tag}: .dbg identical to the sort engine's")

    phase("slice: the Bloom engine through the plain versions on the card")
    out_ref = os.path.join(WORK, "slice_bloom_plain.dbg")
    t0 = time.time()
    bloompipe.build_junctions_bloom(
        [fa], PipelineConfig(k=k, filter_bits=30, engine="bloom", positions_per_row=P,
                             rows_per_batch=B),
        out_ref, device=dev, reference=True)
    torch.cuda.synchronize()
    print(f"plain-version Bloom run: {time.time() - t0:.3f} s wall {label}")
    require(sha256(out_ref) == slice_sha, "Bloom plain run .dbg differs")

    phase(f"slice: the distributed engine ({D4} shards of the card, the CLI, multi-process)")

    def dist_run(tag, rounds, reference=False, filter_bits=None):
        """build_junctions_dist over mesh4 (with the Bloom gate of a
        2^filter_bits-slot filter when given) -> (entries handed to the
        merge, log lines)."""
        out_d = os.path.join(WORK, f"slice_{tag}.dbg")
        lines = []
        gate = dict(filter_bits=filter_bits) if filter_bits else {}
        build.reset_launch_counts()
        t0 = time.time()
        with capture_merge({}) as got:
            enum = distpipe.build_junctions_dist(
                [fa], PipelineConfig(k=k, rounds=rounds, positions_per_row=P, rows_per_batch=B,
                                     **gate),
                mesh4, out_d, log=lines.append, device=dev, reference=reference,
                bloom_gate=bool(filter_bits))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[tag] = build.launch_counts()
        print(f"{tag}: launches {launches[tag]}")
        print(f"{tag} phases (s) {label}: " + ", ".join(
            f"{n}={enum.stats.timings[n]:.3f}" for n in (*distpipe.PHASES, "total")))
        # a shard's rows in one launch each; the shards' entries merge on
        # the card and are written there (the plain run launches nothing)
        if not reference:
            require(launches[tag].get("upload_rows") == D4 and all(
                launches[tag].get(n) == 1 for n in MERGE_PATH) and card_emit(launches[tag]),
                f"{tag}: not {D4} upload launches, one merge and the card emit")
        lines = "\n".join(lines).splitlines()
        for line in lines:
            if line.startswith(("Splitting", "Filter size", "Candidate marks")) or (
                    line.startswith("Round ") and "seconds" in line):
                print(f"{tag}   {line}")
        require(sha256(out_d) == slice_sha, f"{tag}: .dbg differs from SLICE_SHA256")
        print(f"{tag}: {bases_n} bases in {wall:.3f} s wall = {bases_n / wall / 1e6:.2f} "
              f"Mbases/s {label}; .dbg is SLICE_SHA256")
        return got["fetched"], lines

    fetched4, lines = dist_run("dist_r1", 1)
    for name in DIST_PATH:
        require(launches["dist_r1"].get(name, 0) > 0, f"dist_r1: no launch of {name}")
    require(len(fetched4) == D4, f"dist_r1: {len(fetched4)} merge entries, not {D4}")
    # the measurement pass: one histogram launch a shard over its batches
    require(launches["dist_r1"]["word0_histogram"] == D4, "dist_r1: not one word0 launch a shard")
    fetched44, lines = dist_run("dist_r4", ROUNDS)
    for name in (*DIST_PATH, "histogram"):
        require(launches["dist_r4"].get(name, 0) > 0, f"dist_r4: no launch of {name}")
    require(launches["dist_r4"]["word0_histogram"] == launches["dist_r4"]["histogram"] == D4,
            "dist_r4: not one launch of each histogram a shard")
    require(sum(line.startswith("Round ") and "seconds" in line for line in lines) == ROUNDS,
            f"dist_r4: not {ROUNDS} rounds")
    require(len(fetched44) == D4 * ROUNDS, f"dist_r4: {len(fetched44)} merge entries")
    out_c = os.path.join(WORK, "slice_dist_cli.dbg")
    slice_run("dist_cli", ["--tpu-engine", "dist", "-k", str(k), "-f", "30", fa, "-o", out_c],
              phases=distpipe.PHASES)
    for name in DIST_PATH:
        require(launches["dist_cli"].get(name, 0) > 0, f"dist_cli: no launch of {name}")
    require(sha256(out_c) == slice_sha, "dist_cli: .dbg differs from SLICE_SHA256")
    print("dist_cli: .dbg is SLICE_SHA256")

    def multihost_run(tag, kernels, **config):
        """build_junctions_multihost in a child process under a one-rank
        NCCL group, the launch counters read in the child."""
        out_m = os.path.join(WORK, f"slice_{tag}.dbg")
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        spec = dict(fa=fa, out=out_m, bloom_gate="filter_bits" in config,
                    config=dict(k=k, positions_per_row=P, rows_per_batch=B, **config))
        t0 = time.time()
        child = subprocess.run([sys.executable, "-c", MH_CHILD, json.dumps(spec)], cwd=ROOT,
                               env=env, capture_output=True, text=True, timeout=600)
        res = [line for line in child.stdout.splitlines() if line.startswith("MH_RESULT ")]
        require(child.returncode == 0 and res,
                f"{tag} child exited {child.returncode}:\n{child.stdout[-3000:]}"
                f"{child.stderr[-3000:]}")
        mh = json.loads(res[-1][len("MH_RESULT "):])
        launches[tag] = mh["launches"]
        print(f"{tag}: {mh['world']} rank over {mh['backend']}, launches {mh['launches']}, "
              f"run {mh['wall']:.3f} s ({time.time() - t0:.3f} s with the process start) "
              f"{label}")
        for name in kernels:
            require(mh["launches"].get(name, 0) > 0, f"{tag}: no launch of {name}")
        require(mh["backend"] == "nccl", f"{tag} ran over {mh['backend']}, not NCCL")
        require(sha256(out_m) == slice_sha, f"{tag}: .dbg differs from SLICE_SHA256")
        print(f"{tag}: .dbg is SLICE_SHA256")

    multihost_run("multihost", DIST_PATH)

    dist_run("dist_plain", 1, reference=True)
    require(launches["dist_plain"] == {}, "the plain-version run launched kernels")

    phase("merge")
    merge_checks(f"sort -r {ROUNDS} resident", sort_r4["fetched"], cfg, dev, results, label)
    merge_checks(f"dist D={D4} -r 1", fetched4, cfg, dev, results, label)
    merge_checks(f"dist D={D4} -r {ROUNDS}", fetched44, cfg, dev, results, label)
    del sort_r4, fetched44

    del fetched4

    phase("emit")
    emit_checks(fa, cfg, dev, results, label)

    phase("dist-bloom kernels vs plain versions (one slice batch, shards of the card)")
    uploads = sortpipe.upload_batches(wrows, dev)
    for lay, f_bits, n_sh, rows_b, tiny in (
        ("byte", 30, D4, B, False), ("bit", 36, D4, B, False),
        ("byte", 30, 3, B - B % 3, False), ("byte", 30, D4, B, True),
    ):
        scfg = sharded.ShardedConfig(
            base=PassConfig(k=k, f=f_bits, layout=lay, positions_per_row=P,
                            rows_per_batch=rows_b), n_shards=n_sh)
        meshc = LocalMesh([dev] * n_sh)
        per = rows_b // n_sh
        n_pos = per * P
        nt = 4 if f_bits > 32 else 2

        def shard_batch(u):
            return {s: tuple(a[s * per : (s + 1) * per] for a in u) for s in meshc.shards}

        b0 = shard_batch(uploads[0])
        a0 = b0[0]
        cap_f, cap_m = (1024, 1024) if tiny else (scfg.fill_cap, scfg.mark_cap)
        bucket_once = [None, None]
        for marking, cap in ((False, cap_f), (True, cap_m)):
            fn, fn_p = ((shardbloom.bucket_mark, shardbloom.bucket_mark_plain) if marking
                        else (shardbloom.bucket_fill, shardbloom.bucket_fill_plain))
            compare("shard_bucket_mark" if marking else "shard_bucket_fill",
                    lambda: fn(*a0, *full, cfg=scfg.base, n_shards=n_sh, cap=cap),
                    lambda: fn_p(*a0, *full, cfg=scfg.base, n_shards=n_sh, cap=cap),
                    5, results, in_bytes=nbytes(a0),
                    ops=n_pos * (nt * 4 * k + (8 if marking else 4) * 5 * 4))
            over_t = int(fn_p(*a0, *full, cfg=scfg.base, n_shards=n_sh, cap=cap)[-1])
            require((over_t > 0) == tiny, f"shard_bucket cap {cap}: overflow {over_t}")
            print(f"shard_bucket {'mark' if marking else 'fill'} {lay} f={f_bits} "
                  f"D={n_sh} cap {cap}: overflow {over_t}, equal to the plain version's")
            bucket_once[marking] = (lambda fn=fn, cap=cap: fn(*a0, *full, cfg=scfg.base,
                                                                n_shards=n_sh, cap=cap))
        if (lay, f_bits, n_sh, tiny) == ("byte", 30, D4, False):
            # one profiler session (a later one in the process recorded no
            # device event): one call each of route, bucket fill, bucket mark
            cbuf, cstate = stream.new_round_buffer(2 * recs4[1].numel(), w, dev)
            ebuf, estate = extract.new_buffer(round_cands["byte"], w, dev)
            kern = device_kernels(lambda: [c() for c in (
                route_once, *bucket_once,
                lambda: records.build_sort_records_batches(uploads, bases, k=k, P=P),
                lambda: judge.judge_compact(*judge_once),
                lambda: judge.judge_records(*judge_once[:2]),
                lambda: partition.partition_scan(uploads, highs, 0, 0xFFFFFFFF, k=k, P=P,
                                                 part_cap=part_cap),
                lambda: stream.compact_append(*recs4, cbuf, cstate, recs4[1].numel()),
                lambda: lookup.pass4_lookup_batches(uploads, round_masks, slice_table,
                                                    round_cands["byte"], bases, k=k, P=P,
                                                    id_bits=32),
                lambda: extract.extract_records_batches(uploads, round_masks, ebuf, estate,
                                                        bases, k=k, P=P))])
            names = " ".join(kern)
            def count(prefix):
                return sum(c for kk, (c, _t) in kern.items() if kk.startswith(prefix))

            require(all(kern.get(kk, (0,))[0] == 1 for kk in (
                        "k_route", "k_route_tail", "k_shard_bucket<false, false>",
                        "k_shard_bucket<true, false>"))
                    and kern.get("k_shard_tail", (0,))[0] == 2
                    and count("k_records") == 1 and count("k_judge_scan") == 2
                    and count("k_judge_write<true") == count("k_judge_write<false") == 1
                    and count("k_partition<") == count("k_part_tail") == 1
                    and count("k_compact_real") == count("k_compact_rest") == 1
                    and count("k_lookup<") == count("k_lookup_tail") == 1
                    and count("k_extract<") == count("k_extract_tail") == 1
                    and "k_scan" not in names and "k_shard_count" not in names
                    and "Memset" not in names,
                    f"route, shard_bucket, build_records, judge, partition, compact, lookup, "
                    f"extract: device launches of one call each {kern}")
            print(f"route, shard_bucket fill, shard_bucket mark, build_records (the -r 1 "
                  f"round's {len(uploads)} batches), judge_compact and judge_records (the "
                  f"long_group case, {judge_once[0].shape[0]} records), partition_scan (the "
                  f"-r {ROUNDS} pass's {len(uploads)} batches), compact_append (shard 0's "
                  f"{recs4[1].numel()} records), pass4_lookup_batches and "
                  f"extract_records_batches (the -r 1 run's {len(uploads)} batches): device "
                  f"launches of one call each "
                  f"({sum(t for _c, t in kern.values()):.4f} ms on the device): "
                  + ", ".join(f"{kk} x{c} {t:.4f} ms" for kk, (c, t) in kern.items()))
            require(estate.tolist() == [round_cands["byte"], 0],
                    f"profiled extract state {estate.tolist()}")
            del route_once, recs4, send_k, judge_once, cbuf, cstate, ebuf, estate, round_masks
            del slice_table
        if tiny:
            continue
        # the whole slice into the sharded filter, as the main path fills it
        filt = sharded.make_sharded_filter(meshc, scfg)
        fill_k = sharded.sharded_fill_step(meshc, scfg)
        over = None
        for u in uploads:
            over = fill_k(filt, shard_batch(u), *full, over)
        require(int(meshc.all_gather(over).sum()) == 0, "sharded fill overflowed")
        if (lay, f_bits, n_sh) == ("byte", 30, D4):
            filt_p = sharded.make_sharded_filter(meshc, scfg)
            fill_p = sharded.sharded_fill_step(meshc, scfg, versions.PLAIN)
            over = None
            for u in uploads:
                over = fill_p(filt_p, shard_batch(u), *full, over)
            err = max_abs_err([filt[s] for s in meshc.shards], [filt_p[s] for s in meshc.shards])
            require(err == 0, f"sharded filter of the slice differs from the plain one ({err})")
            print(f"sharded filter of the whole slice ({n_sh} shards): equal to the plain fill's")
            del filt_p
        # batch 0: shard 0's received fill slots, into an empty shard
        sends = {s: (shardbloom.bucket_fill(*b0[s], *full, cfg=scfg.base, n_shards=n_sh,
                                            cap=cap_f)[0],) for s in meshc.shards}
        recv_f = meshc.all_to_all(sends)[0][0].view(n_sh, cap_f)
        del sends
        valid_f = recv_f[recv_f != shardbloom.SENT]
        fk, fp = torch.zeros_like(filt[0]), torch.zeros_like(filt[0])
        # the bound under the prefix rows: the sent slots read (8 bytes),
        # each distinct 32-byte filter sector that they set read and written
        # once, and one 32-byte sector a block of FILL_CHUNK slots (its
        # first slot)
        chunks = n_sh * -(-cap_f // FILL_CHUNK)
        fl = sector_flags(fk)
        flag_sectors(fl, valid_f, lay)
        n_fs = int(fl.sum())
        del fl
        compare("shard_fill", lambda: (shardbloom.fill_local(fk, recv_f, lay),),
                lambda: (shardbloom.fill_local_plain(fp, recv_f, lay),), 5, results,
                in_bytes=valid_f.numel() * 8 + n_fs * SECTOR + chunks * 32,
                out_bytes=n_fs * SECTOR,
                library=(lambda: fp.index_fill_(0, valid_f, 1)) if lay == "byte" else None)
        if lay == "byte":
            fresh_fill_times(tag=f"shard_fill {lay} f={f_bits} D={n_sh}", filt=fk,
                             kernel=lambda: shardbloom.fill_local(fk, recv_f, lay),
                             library=lambda: fk.index_fill_(0, valid_f, 1))
        del fk, fp
        # batch 0's probes, exchanged, probed against the slice's filter
        sends, slots = {}, {}
        for s in meshc.shards:
            send, slots[s], _o = shardbloom.bucket_mark(*b0[s], *full, cfg=scfg.base,
                                                        n_shards=n_sh, cap=cap_m)
            sends[s] = (send,)
        recv_m = meshc.all_to_all(sends)
        del sends
        r0 = recv_m[0][0].view(n_sh, cap_m)
        valid_m = r0[r0 != shardbloom.SENT]
        n_sent = valid_m.numel()
        # the bound under the prefix rows: the sent slots read (8 bytes),
        # each distinct 32-byte filter sector that they probe read once,
        # every hit written, and one 32-byte sector a block of PROBE_CHUNK
        # slots (its first slot) (50 calls a timing, so that the host time
        # before the first launch, more for the wrapper than for
        # index_select, is spread thin)
        p_chunks = n_sh * -(-cap_m // PROBE_CHUNK)
        compare("shard_probe", lambda: (shardbloom.probe_local(filt[0], r0, lay),),
                lambda: (shardbloom.probe_local_plain(filt[0], r0, lay),), 50, results,
                in_bytes=n_sent * 8 + probe_sectors(filt[0], valid_m, lay) * SECTOR
                + p_chunks * 32,
                library=(lambda: filt[0].index_select(0, valid_m)) if lay == "byte" else None)
        print(f"shard_probe {lay} f={f_bits} D={n_sh}: {n_sent} sent of {r0.numel()} slots")
        if n_sh == D4:
            for off, cap_h in ((0, cap_m), (1, cap_m + 5)):
                blk = prefix_block(f_bits + off, n_sh, cap_h, scfg.local_slots, dev, off)
                sent_h = int((blk != shardbloom.SENT).sum())
                compare("shard_probe", lambda: (shardbloom.probe_local(filt[0], blk, lay),),
                        lambda: (shardbloom.probe_local_plain(filt[0], blk, lay),), 2, results,
                        in_bytes=sent_h * 8 + n_sh * -(-cap_h // PROBE_CHUNK) * 32
                        + probe_sectors(filt[0], blk[blk != shardbloom.SENT], lay) * SECTOR)
                print(f"shard_probe {lay} f={f_bits}: hand-made prefix rows, cap {cap_h}, "
                      f"offset {8 * off} bytes, {sent_h} sent: exact")
                del blk
        hits = {s: (shardbloom.probe_local(filt[s], recv_m[s][0].view(n_sh, cap_m),
                                           lay).view(n_sh, cap_m),)
                for s in meshc.shards}
        back = meshc.all_to_all(hits)
        del hits, recv_m
        # the finish reads its probe slots, the upload form and one hit a
        # sent probe (not the whole returned block)
        sent_m = int((slots[0] >= 0).sum())
        compare("shard_mark_finish",
                lambda: shardbloom.mark_finish(back[0][0], slots[0], *a0, *full, cfg=scfg.base),
                lambda: shardbloom.mark_finish_plain(back[0][0], slots[0], *a0, *full,
                                                     cfg=scfg.base),
                5, results, in_bytes=nbytes(slots[0], a0) + sent_m, ops=n_pos * 4 * k)
        marked = [shardbloom.mark_finish(back[s][0], slots[s], *b0[s], *full, cfg=scfg.base)
                  for s in meshc.shards]
        n_cand = sum(int(c) for _m, c in marked)
        print(f"dist-bloom {lay} f={f_bits} D={n_sh}: shard filter "
              f"{nbytes(filt[0])} bytes; batch 0, shard 0: {valid_f.numel()} fill slots, "
              f"{valid_m.numel()} probes; batch 0: {n_cand} candidates")
        if (lay, f_bits, n_sh) == ("byte", 30, D4):
            same = torch.equal(torch.cat([m for m, _c in marked]), mask0)
            require(same and n_cand == count0,
                    f"sharded mark of batch 0 ({n_cand}) differs from the Bloom engine's "
                    f"({count0})")
            print("dist-bloom byte f=30: batch 0's mask equals the Bloom engine's")
        del filt, back, slots, marked, recv_f, valid_f, r0, valid_m
        torch.cuda.synchronize()
    del uploads, mask0

    phase(f"slice: the dist-bloom engine ({D4} shards of the card, the CLI, multi-process)")
    for tag, rounds, f_bits, layout in (
        ("dist_bloom_r1", 1, 30, "byte"), ("dist_bloom_f36", 1, 36, "bit"),
        ("dist_bloom_f36_r4", ROUNDS, 36, "bit"),
    ):
        _fetched, lines = dist_run(tag, rounds, filter_bits=f_bits)
        for name in DIST_BLOOM_PATH:
            require(launches[tag].get(name, 0) > 0, f"{tag}: no launch of {name}")
        require(any(f"({layout} layout" in line for line in lines), f"{tag}: not {layout}")
        require(sum(line.startswith("Round ") and "seconds" in line for line in lines)
                == rounds, f"{tag}: not {rounds} rounds")
    del _fetched
    out_c = os.path.join(WORK, "slice_dist_bloom_cli.dbg")
    slice_run("dist_bloom_cli", ["--tpu-engine", "dist-bloom", "-k", str(k), "-f", "30", fa,
                                 "-o", out_c], phases=distpipe.PHASES)
    for name in DIST_BLOOM_PATH:
        require(launches["dist_bloom_cli"].get(name, 0) > 0, f"dist_bloom_cli: no {name}")
    require(sha256(out_c) == slice_sha, "dist_bloom_cli: .dbg differs from SLICE_SHA256")
    print("dist_bloom_cli: .dbg is SLICE_SHA256")
    multihost_run("multihost_bloom", DIST_BLOOM_PATH, filter_bits=30)
    dist_run("dist_bloom_plain", 1, reference=True, filter_bits=30)
    require(launches["dist_bloom_plain"] == {}, "the plain dist-bloom run launched kernels")

    phase("native")
    native_checks(fa, slice_run, launches, label)

    phase("serve")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the daemon plans its rounds from the card's free memory
    serve_checks(fa, k, label)
    shutil.rmtree(WORK, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        rs = results[name]
        first = next(r for r in rs if "ms" in r)  # the first timed compare
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[PATH_OF[name]][name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
