#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from twopaco_tpu_torch/kernels/csrc;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes of the benchmark slice (exact: integer data), and times
   both with CUDA events; the round sort also on the slice's k = 101
   round (sort_records_k101, 7 key words);
4. runs the port's CLI on two inputs whose .dbg sha256 the JAX package
   gave (tests/golden/torch_port_sha256.json) and checks the bytes;
5. runs the slice: 8 genomes x 8,000,000 bases (seed 2016) through
   `twopaco_tpu_torch.cli.twopaco.main(["-k", "25", "-f", "30", ...])`,
   with every kernel's launch counter reset just before and read just
   after; its .dbg sha256 must be SLICE_SHA256; then the same input
   through the plain versions on the card, whose .dbg must be
   byte-identical;
6. runs the slice in four rounds (-r 4) in each multi-round mode:
   resident, grouped (TWOPACO_RESIDENT_BYTES at half the resident
   blocks' bytes: 2 groups of 2 rounds), stream (TWOPACO_RESIDENT=0 and
   TWOPACO_GROUPED=0) and histogram split (TWOPACO_UNIFORM_SPLIT=0), each
   with the counters reset just before and read just after; each must
   launch its mode's kernels and write the -r 1 run's bytes; then -r 4
   resident through the plain versions on the card, the same bytes again;
7. holds the Bloom engine's four kernels (fill, mark, extract, lookup)
   against their plain versions at one slice batch: fill (the whole
   slice's filter, each version filling its own) and mark in the byte
   layout at f=30, the bit layout at f=34 (64-bit probe indices) and the
   block layout at f=30, extract on the byte mask, lookup against the
   slice's junction table;
8. runs the slice through the Bloom engine (`--tpu-engine bloom`): -f 30
   (auto: byte), --tpu-layout bit -f 34, --tpu-layout block -f 30, and
   -f 30 -r 4, each with the counters reset just before and read just
   after; each must launch the Bloom kernels and the sort and judge of
   its verify pass and write SLICE_SHA256; then a Bloom run through the
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
   reset just before and read just after, each launching its kernels and
   writing SLICE_SHA256: build_junctions_dist over a LocalMesh of 4
   shards of the card at -r 1 and -r 4, the CLI's `--tpu-engine dist`
   (one shard), build_junctions_multihost in a child process under a
   one-rank NCCL group, and the 4-shard run through the plain versions;
   and times the merge's final occurrence sort both ways (np.sort
   default and kind="stable") on the sort engine's and the 4-shard run's
   occurrences;
11. holds the dist-bloom engine's four kernels (bloom_shard.cu: bucket,
   fill, probe, mark finish) against their plain versions at one slice
   batch's shard, the sharded filter filled with the whole slice: byte
   layout at f=30 over 4 shards of the card (the whole filter also filled
   by the plain versions and compared, and the batch's mask equal to the
   Bloom engine's), bit layout at f=36 (64-bit global and local slots), 3
   shards (255 rows a batch), and a tiny cap whose overflow counts must
   match; the byte fill is also timed into a zeroed shard, every slot new;
   the probe is also held against its plain version on hand-made received
   blocks (rows of 0, cap, chunk-boundary and random sent counts; the mark
   cap, and an odd cap starting 8 bytes off 16-byte alignment), and the
   device kernels of one call each of the route (above) and of the
   bucket's two modes are listed with their device times by one
   torch.profiler session (k_route and k_route_tail; one bucketing kernel
   a mode; no count or scan kernel, no memset);
12. runs the slice through the dist-bloom engine, each with the counters
   reset just before and read just after, each launching the four
   entries and the dist engine's kernels and writing SLICE_SHA256:
   build_junctions_dist(bloom_gate=True) over 4 shards of the card at -f 30
   and at -f 36 (the bit layout, 8 GiB of filter, which the Bloom engine
   refuses on one card) at -r 1 and -r 4, the CLI's `--tpu-engine
   dist-bloom -f 30` (one shard), build_junctions_multihost(bloom_gate=True)
   in a one-rank NCCL child process, and the 4-shard -f 30 run through the
   plain versions.

Every kernel comparison also prints the kernel's bound (the larger of the
bytes it must move over 3.35 TB/s and its integer operations over 67 T/s)
and, where one PyTorch call computes the same function, that call's time.

Exits non-zero, printing no result, if there is no CUDA device, if the
package is missing, or if any phase fails. The last line of standard
output is the result object.
"""

from __future__ import annotations

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
             "TWOPACO_UNIFORM_SPLIT", "TWOPACO_POS64")
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
}
D4 = 4  # shards of the card in the distributed runs
FILL_CHUNK = 4096  # received slots a block of bloom_shard.cu's fill
PROBE_CHUNK = 4096  # ... and of its probe
# the kernels each distributed path must launch
DIST_PATH = ("word0_histogram", "build_records", "route", "compact", "sort_records",
             "judge_compact", "sort_occurrences")
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
BLOOM_PATH = ("bloom_fill", "bloom_mark", "bloom_extract", "sort_records",
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


def compare(name, kernel, plain, reps, results, in_bytes=0, ops=0, out_bytes=None,
            library=None):
    """Run kernel and plain on the same inputs: exact agreement, and
    times taken in turns (plain, kernel, kernel, plain). The bound counts
    in_bytes read, out_bytes written (default: the kernel's outputs) and
    ops integer operations; library: one PyTorch call computing the same
    function, timed beside them (never used by the port)."""
    import torch

    got = kernel()
    err = max_abs_err(got, plain())
    torch.cuda.synchronize()
    require(err == 0, f"{name}: kernel disagrees with its plain version (max abs err {err})")
    bound_ms, bound_by = bound(in_bytes + (nbytes(got) if out_bytes is None else out_bytes), ops)
    del got
    p1 = timed(plain, reps)
    k1 = timed(kernel, reps)
    k2 = timed(kernel, reps)
    p2 = timed(plain, reps)
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


def occ_sort_times(tag, fetched, w, label, reps=5):
    """The merge's final occurrence sort on a run's entries, both np.sort
    kinds, host seconds (mean of reps on copies of one buffer)."""
    import numpy as np

    from twopaco_tpu_torch.passes import sortpipe

    _table, inv = sortpipe.merge_tables(fetched, w)
    buf = sortpipe.packed_occurrences(fetched, inv, 32)
    times = {}
    for kind in ("quicksort", "stable", "stable", "quicksort"):
        dt = 0.0
        for _ in range(reps):
            b = buf.copy()
            t0 = time.time()
            b.sort(kind=kind)
            dt += time.time() - t0
        times.setdefault(kind, []).append(dt / reps)
        require(np.array_equal(b, np.sort(buf)), f"{tag}: np.sort kind {kind} differs")
    print(f"merge occurrence sort {tag}: {len(buf)} keys in {len(fetched)} entries, "
          + ", ".join(f"{k}={sum(v) / len(v):.4f} s" for k, v in times.items())
          + f" (host of {label}; the merge sorts with kind=stable)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        import numpy as np

        from twopaco_tpu_torch.io import fasta, windows
        from twopaco_tpu_torch.kernels import build
        from twopaco_tpu_torch.ops import pack
        from twopaco_tpu_torch.ops import bloom
        from twopaco_tpu_torch.parallel import distpipe, sharded, sortshard
        from twopaco_tpu_torch.parallel.mesh import LocalMesh
        from twopaco_tpu_torch.passes import (
            bloompipe, extract, fill, histogram, judge, lookup, mark, occ, partition,
            records, route, shardbloom, sort, sortpipe, stream,
        )
        from twopaco_tpu_torch.passes.pipeline import PassConfig, PipelineConfig
        from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted
        from twopaco_tpu_torch.testing import bench_data
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

    phase("kernels vs plain versions")
    results: dict = {}
    launches: dict = {}  # a path's launch counts, read just after its run

    def upload(batch):
        p, m = pack.pack_codes_host(batch.codes)
        return [torch.from_numpy(a).to(dev) for a in (p, m, batch.valid)]

    # record build: one batch at k=25 (full gate and a narrow hash gate)
    # and one at k=101
    args = upload(batches[0])
    for low, high in ((0, 0xFFFFFFFF), (1 << 30, 3 << 30)):
        compare(
            "build_records",
            lambda: records.build_sort_records(*args, 0, k=k, P=P, low=low, high=high),
            lambda: records.build_sort_records_plain(*args, 0, k=k, P=P, low=low, high=high),
            10, results, in_bytes=nbytes(args), ops=B * P * 6 * k,
        )
    cfg101 = PipelineConfig(k=101, positions_per_row=P, rows_per_batch=B)
    b101 = next(windows.iter_window_batches(iter(seqs), cfg101.window_config()))
    args101 = upload(b101)
    compare(
        "build_records_k101",
        lambda: records.build_sort_records(*args101, 0, k=101, P=P),
        lambda: records.build_sort_records_plain(*args101, 0, k=101, P=P),
        5, results, in_bytes=nbytes(args101), ops=B * P * 6 * 101,
    )
    # the slice's whole round buffer, built as the main path builds it
    w = cfg.w
    buf = (
        torch.empty((n_slots, w), dtype=torch.uint32, device=dev),
        torch.empty(n_slots, dtype=torch.uint32, device=dev),
        torch.empty(n_slots, dtype=torch.int64, device=dev),
    )
    for b in batches:
        off = b.row0 * P
        records.build_sort_records(
            *upload(b), off, k=k, P=P,
            out=tuple(t[off : off + B * P] for t in buf),
        )
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
        compare(
            "judge_compact",
            lambda: judge.judge_compact(*srt, ab),
            lambda: judge.judge_compact_plain(*srt, ab),
            3, results, in_bytes=nbytes(srt),
        )
    slice_table, slice_occ_pos, slice_occ_id = (
        t.clone() for t in judge.judge_compact(*srt)[:3])  # Bloom lookup, occurrence sort
    del srt
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
    uploads = [upload(b) for b in batches]
    bases = [b.row0 * P for b in batches]
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
    # resident partition into the path's blocks: 4 rounds, cap 1.25 B*P / 4
    intervals = sortpipe._live_intervals(np.ones(1 << 16, np.int64), ROUNDS)
    highs = [h for _l, h in intervals]
    part_cap = -(-int(cfg.round_slack * bp) // len(intervals))
    highs_d = pack.as_u32(torch.tensor(highs, dtype=torch.int64, device=dev))
    compare(
        "partition",
        lambda: partition.partition_batch(*args, highs_d, 0, 0xFFFFFFFF, k=k, P=P,
                                          part_cap=part_cap),
        lambda: partition.partition_batch_plain(*args, highs_d, 0, 0xFFFFFFFF, k=k,
                                                P=P, part_cap=part_cap),
        5, results, in_bytes=nbytes(args, highs_d), ops=B * P * 6 * k,
    )
    *blocks, counts = partition.partition_scan(
        uploads, highs, 0, 0xFFFFFFFF, k=k, P=P, part_cap=part_cap)
    *blocks_p, counts_p = partition.partition_scan(
        uploads, highs, 0, 0xFFFFFFFF, k=k, P=P, part_cap=part_cap,
        fn=partition.partition_batch_plain)
    require(np.array_equal(counts, counts_p) and (counts <= part_cap).all(),
            "partition scan counts differ from the plain ones, or overflow")
    err = max_abs_err(blocks, blocks_p)
    require(err == 0, f"partition scan blocks differ from the plain ones ({err})")
    del blocks_p
    print(f"partition scan: blocks {tuple(blocks[0].shape)} exact "
          f"({sum(t.numel() * t.element_size() for t in blocks) / 1e9:.2f} GB)")
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
        src = spec["input"]
        if src.startswith("bench:"):
            n, length, seed = (int(x) for x in src[6:].split(":"))
            src = bench_data.write_bench_fasta(
                os.path.join(WORK, f"{name}.fa"), n, length, seed)
        else:
            src = os.path.join(ROOT, src)
        out = os.path.join(WORK, f"{name}.dbg")
        run_cli(["-k", str(spec["k"]), "-f", "20", src, "-o", out])
        got = sha256(out)
        require(got == spec["sha256"], f"{name}: .dbg sha256 {got} != {spec['sha256']}")
        print(f"golden {name}: sha256 matches the JAX package")
    torch.cuda.synchronize()

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
    with capture_merge({}) as sort_r1:
        slice_run("r1", ["-k", str(k), "-f", "30", fa, "-o", out])
    for name in ("build_records", "sort_records", "judge_compact", "sort_occurrences"):
        require(launches["r1"].get(name, 0) > 0, f"{name}: no launch in the slice run")
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
    for tag, (env, kernels, split_line) in modes.items():
        out_r = os.path.join(WORK, f"slice_r{ROUNDS}_{tag}.dbg")
        text, _wall = slice_run(tag, ["-k", str(k), "-f", "30", "-r", str(ROUNDS), fa,
                                      "-o", out_r], env)
        for name in (*kernels, "sort_records", "judge_compact"):
            require(launches[tag].get(name, 0) > 0, f"{tag}: no launch of {name}")
        require(launches[tag].get("histogram", 1) == 1, f"{tag}: not one histogram launch")
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

    phase("Bloom kernels vs plain versions (one slice batch)")
    bcfgs = {
        "byte": PassConfig(k=k, f=30, layout="byte", positions_per_row=P, rows_per_batch=B),
        "bit": PassConfig(k=k, f=34, layout="bit", positions_per_row=P, rows_per_batch=B),
        "block": PassConfig(k=k, f=30, layout="block", positions_per_row=P, rows_per_batch=B),
    }
    full = (0, 0xFFFFFFFF)
    uploads = [upload(b) for b in batches[1:]]
    for lay, bcfg in bcfgs.items():
        filt_k = bloom.make_filter(bcfg.f, lay, dev)
        filt_p = bloom.make_filter(bcfg.f, lay, dev)
        # the rest of the slice first, each filter by its own version, so
        # that batch 0 is marked against the whole input's filter
        for u in uploads:
            fill.bloom_fill(filt_k, *u, *full, cfg=bcfg)
            fill.bloom_fill_plain(filt_p, *u, *full, cfg=bcfg)
        # the bound's filter traffic: one slot a distinct insert (fill), one
        # probe a position in the round (mark); hashing: 4 operations a char
        # a table
        codes0 = fill.batch_codes(args[0], args[1], bcfg)
        slot_b = 1 if lay == "byte" else 4
        if lay == "block":
            n_ins = int(fill.fill_indices_block(codes0, args[2], *full, bcfg)[2].sum()) * bcfg.q
        else:
            n_ins = int(fill.fill_indices(codes0, args[2], *full, bcfg)[1].sum())
        n_base = int(mark.mark_common(codes0, args[2], *full, bcfg, fill.ALL_TABLES[:1])[2].sum())
        hash_ops = B * P * len(fill.tables(bcfg)) * 4 * k
        del codes0
        # OR is idempotent: every repeat of a fill leaves the same filter
        compare("bloom_fill",
                lambda: (fill.bloom_fill(filt_k, *args, *full, cfg=bcfg),),
                lambda: (fill.bloom_fill_plain(filt_p, *args, *full, cfg=bcfg),),
                5, results, in_bytes=nbytes(args), out_bytes=n_ins * slot_b, ops=hash_ops)
        del filt_p
        compare("bloom_mark",
                lambda: mark.bloom_mark(filt_k, *args, *full, cfg=bcfg),
                lambda: mark.bloom_mark_plain(filt_k, *args, *full, cfg=bcfg),
                5, results, in_bytes=nbytes(args) + n_base * slot_b, ops=hash_ops)
        bmask, bcount = mark.bloom_mark(filt_k, *args, *full, cfg=bcfg)
        print(f"Bloom {lay} f={bcfg.f}: filter {filt_k.numel() * filt_k.element_size()} "
              f"bytes, {int(bcount)} candidates of {B * P} positions")
        if lay == "byte":
            mask0, count0 = bmask, int(bcount)
        del filt_k, bmask
    del uploads
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
    compare(
        "bloom_lookup",
        lambda: lookup.pass4_lookup(*args, mask0, slice_table, count0, k=k, P=P),
        lambda: lookup.pass4_lookup_plain(*args, mask0, slice_table, count0, k=k, P=P),
        10, results, in_bytes=nbytes(args, mask0) + count0 * 4 * w, ops=count0 * 6 * k,
    )
    n_hit = int(lookup.pass4_lookup(*args, mask0, slice_table, count0, k=k, P=P)[2])
    require(n_hit > 0, "lookup found no junction in the first batch")
    print(f"lookup: {n_hit} of {count0} candidates found among "
          f"{slice_table.shape[0]} junctions")
    del slice_table
    torch.cuda.synchronize()

    phase("slice: the Bloom engine (--tpu-engine bloom)")
    for tag, (flags, layout) in BLOOM_RUNS.items():
        out_b = os.path.join(WORK, f"slice_{tag}.dbg")
        text, _wall = slice_run(tag, ["--tpu-engine", "bloom", "-k", str(k), *flags, fa,
                                      "-o", out_b], phases=bloompipe.PHASES)
        for name in BLOOM_PATH:
            require(launches[tag].get(name, 0) > 0, f"{tag}: no launch of {name}")
        require(f"({layout} layout)" in text, f"{tag}: not the {layout} layout")
        n_rounds = ROUNDS if "-r" in flags else 1
        require(sum(line.startswith("Round ") and "seconds" in line
                    for line in text.splitlines()) == n_rounds, f"{tag}: not {n_rounds} rounds")
        for line in text.splitlines():
            if line.startswith(("Candidate marks", "False junctions")):
                print(f"{tag}   {line}")
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
    _fetched, lines = dist_run("dist_r4", ROUNDS)
    for name in (*DIST_PATH, "histogram"):
        require(launches["dist_r4"].get(name, 0) > 0, f"dist_r4: no launch of {name}")
    require(launches["dist_r4"]["word0_histogram"] == launches["dist_r4"]["histogram"] == D4,
            "dist_r4: not one launch of each histogram a shard")
    require(sum(line.startswith("Round ") and "seconds" in line for line in lines) == ROUNDS,
            f"dist_r4: not {ROUNDS} rounds")
    del _fetched
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

    phase("the merge's final occurrence sort, both np.sort kinds")
    occ_sort_times("sort -r 1", sort_r1["fetched"], w, label)
    occ_sort_times(f"dist -r 1 ({D4} shards)", fetched4, w, label)
    del fetched4

    phase("dist-bloom kernels vs plain versions (one slice batch, shards of the card)")
    uploads = [upload(b) for b in batches]
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
        slot_b = 1 if lay == "byte" else 4

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
            kern = device_kernels(lambda: [c() for c in (route_once, *bucket_once)])
            names = " ".join(kern)
            require(all(kern.get(kk, (0,))[0] == 1 for kk in (
                        "k_route", "k_route_tail", "k_shard_bucket<false, false>",
                        "k_shard_bucket<true, false>"))
                    and kern.get("k_shard_tail", (0,))[0] == 2
                    and "k_scan" not in names and "k_shard_count" not in names
                    and "Memset" not in names,
                    f"route, shard_bucket: device launches of one call each {kern}")
            print(f"route, shard_bucket fill, shard_bucket mark: device launches of one call "
                  f"each ({sum(t for _c, t in kern.values()):.4f} ms on the device): "
                  + ", ".join(f"{kk} x{c} {t:.4f} ms" for kk, (c, t) in kern.items()))
            del route_once, recs4, send_k
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
            fill_p = sharded.sharded_fill_step(meshc, scfg, sortshard.PLAIN)
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
        # the bound under the prefix rows: the sent slots read and set, and
        # one 32-byte sector a block of FILL_CHUNK slots (its first slot)
        chunks = n_sh * -(-cap_f // FILL_CHUNK)
        compare("shard_fill", lambda: (shardbloom.fill_local(fk, recv_f, lay),),
                lambda: (shardbloom.fill_local_plain(fp, recv_f, lay),), 5, results,
                in_bytes=valid_f.numel() * 8 + chunks * 32, out_bytes=valid_f.numel() * slot_b,
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
        # the bound under the prefix rows: the sent slots read (8 bytes and
        # their filter slot), every hit written, and one 32-byte sector a
        # block of PROBE_CHUNK slots (its first slot)
        # (50 calls a timing, so that the host time before the first
        # launch, more for the wrapper than for index_select, is spread thin)
        p_chunks = n_sh * -(-cap_m // PROBE_CHUNK)
        compare("shard_probe", lambda: (shardbloom.probe_local(filt[0], r0, lay),),
                lambda: (shardbloom.probe_local_plain(filt[0], r0, lay),), 50, results,
                in_bytes=n_sent * (8 + slot_b) + p_chunks * 32,
                library=(lambda: filt[0].index_select(0, valid_m)) if lay == "byte" else None)
        print(f"shard_probe {lay} f={f_bits} D={n_sh}: {n_sent} sent of {r0.numel()} slots; "
              f"their random filter sectors, {n_sent} x 32 B over 3.35 TB/s: "
              f"{n_sent * 32 / HBM_BYTES_PER_S * 1e3:.4f} ms (beside the bound)")
        if n_sh == D4:
            for off, cap_h in ((0, cap_m), (1, cap_m + 5)):
                blk = prefix_block(f_bits + off, n_sh, cap_h, scfg.local_slots, dev, off)
                sent_h = int((blk != shardbloom.SENT).sum())
                compare("shard_probe", lambda: (shardbloom.probe_local(filt[0], blk, lay),),
                        lambda: (shardbloom.probe_local_plain(filt[0], blk, lay),), 2, results,
                        in_bytes=sent_h * (8 + slot_b) + n_sh * -(-cap_h // PROBE_CHUNK) * 32)
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
    shutil.rmtree(WORK, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        rs = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[PATH_OF[name]][name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            **{key: rs[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
