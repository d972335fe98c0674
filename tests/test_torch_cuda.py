"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped on hosts without a CUDA device. Run on a GPU host with:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX, which a GPU host need
not have; this file imports no JAX.) Integer data: every comparison is
exact.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from twopaco_tpu_torch import dna, trace
from twopaco_tpu_torch.cli import twopaco as cli
from twopaco_tpu_torch.io import junctions, native, windows
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import bloom, pack
from twopaco_tpu_torch.parallel import distpipe, sharded, sortshard
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.passes import (
    emit, extract, fill, histogram, judge, lookup, mark, merge, occ, partition, records,
    route, shardbloom, sort, sortpipe, stream, upload, versions,
)
from twopaco_tpu_torch.passes.pipeline import (
    PassConfig, PipelineConfig, build_junctions,
)
from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted
from twopaco_tpu_torch.testing import bench_data, emit_cases, judge_cases, oracle

pytestmark = pytest.mark.cuda
NO_AB = judge.NO_ABUNDANCE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(a, b):
    if a.dtype == torch.uint32:
        a, b = pack.as_i64(a), pack.as_i64(b)
    return torch.equal(a.cpu(), b.cpu())


def _genome_batch(rng, B, P, k, n_rate=0.01):
    """(packed, nmask, valid) numpy of B rows cut from a few related
    genomes (shared k-mers, so junction groups form)."""
    R = P + k + 1
    base = rng.integers(0, 4, size=R * 2).astype(np.uint8)
    rows = []
    for _ in range(B):
        s = rng.integers(0, R)
        row = base[s : s + R].copy()
        if len(row) < R:
            row = np.concatenate([row, rng.integers(0, 4, R - len(row)).astype(np.uint8)])
        flip = rng.random(R) < 0.02
        row[flip] = rng.integers(0, 4, size=int(flip.sum()))
        row[rng.random(R) < n_rate] = 4
        rows.append(row)
    codes = np.stack(rows)
    valid = rng.integers(0, P + 1, size=B).astype(np.int32)
    valid[: B // 2] = P
    p, m = pack.pack_codes_host(codes)
    return p, m, valid


def _to(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("k", [11, 25, 33, 101])
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_build_records_kernel(dev, k, gate):
    rng = np.random.default_rng(k)
    B, P = 16, 512
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    p, m, v = _genome_batch(rng, B, P, k)
    args = _to(dev, p, m, v)
    build.reset_launch_counts()
    got = records.build_sort_records(*args, 12345, k=k, P=P, low=low, high=high)
    assert build.launch_counts() == {"build_records": 1}
    want = records.build_sort_records_plain(*args, 12345, k=k, P=P, low=low, high=high)
    for a, b in zip(got, want):
        assert _equal(a, b)


def _random_records(rng, m, w, dup_frac=0.5, sent_frac=0.1):
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    words[:, 0] |= np.uint32(1 << 31) * (rng.random(m) < 0.5).astype(np.uint32)
    dup = rng.random(m) < dup_frac
    words[dup] = words[rng.integers(0, max(m // 8, 1), size=int(dup.sum()))]
    sent = rng.random(m) < sent_frac
    words[sent] = 0xFFFFFFFF
    ext = rng.integers(0, 5, size=(m, 2)).astype(np.uint32)
    pay = ext[:, 0] | (ext[:, 1] << 8) | (rng.integers(0, 2, m).astype(np.uint32) << 16)
    pay = np.where(sent, 0, pay | (1 << 17)).astype(np.uint32)
    pos = rng.permutation(m).astype(np.int64) + (1 << 33)
    return words, pay, pos


@pytest.mark.parametrize(
    "m,w", [(1, 1), (4095, 2), (4097, 2), (100_003, 2), (70_001, 1), (30_011, 7)]
)
def test_sort_kernel(dev, m, w):
    rng = np.random.default_rng(m + w)
    args = _to(dev, *_random_records(rng, m, w))
    build.reset_launch_counts()
    got = sort.sort_records(*args, key_bits=32 * w)
    assert build.launch_counts() == {"sort_records": 1}
    want = sort.sort_records_plain(*args, key_bits=32 * w)
    for a, b in zip(got, want):
        assert _equal(a, b)


TILE = sort.SORT_TILE
KEY_BITS_K = [9, 15, 17, 25, 31, 33, 101, 129, 603]


def _sort_equal(dev, args, key_bits):
    build.reset_launch_counts()
    got = sort.sort_records(*args, key_bits=key_bits)
    assert build.launch_counts() == {"sort_records": 1}
    want = sort.sort_records_plain(*args, key_bits=key_bits)
    for a, b in zip(got, want):
        assert _equal(a, b)


@pytest.mark.parametrize("m", [0, 1, TILE - 1, TILE, TILE + 1, 100_003])
@pytest.mark.parametrize("k", KEY_BITS_K)
def test_sort_kernel_key_bits(dev, k, m):
    """key_bits = 2k over random words (random bits below the k-mer, 80%
    duplicates, sentinels): exact against the plain version, which masks
    the same bits; tile edges and every word count."""
    w = -(-2 * k // 32)
    rng = np.random.default_rng(k * 1000 + m)
    _sort_equal(dev, _to(dev, *_random_records(rng, m, w, dup_frac=0.8)), 2 * k)


@pytest.mark.parametrize("k", [25, 33])
def test_sort_kernel_large(dev, k):
    """Past 2^24 records: thousands of tiles in the look-back."""
    w = -(-2 * k // 32)
    rng = np.random.default_rng(k)
    _sort_equal(dev, _to(dev, *_random_records(rng, (1 << 24) + 5, w)), 2 * k)


@pytest.mark.parametrize("k", [25, 33, 101])
@pytest.mark.parametrize("sentinels", [False, True])
def test_sort_kernel_one_kmer(dev, k, sentinels):
    """One k-mer repeated (random padding below it): every record in one
    digit of every pass, the look-back's worst skew; stable."""
    w = -(-2 * k // 32)
    rng = np.random.default_rng(k + sentinels)
    m = 50 * TILE + 17
    words, pay, pos = _random_records(rng, m, w, dup_frac=0.0, sent_frac=0.2 if sentinels else 0)
    one = rng.integers(0, 1 << 32, size=w, dtype=np.uint64).astype(np.uint32)
    one[0] &= 0x7FFFFFFF
    keep = np.array([(((1 << b) - 1) << (32 - b)) & 0xFFFFFFFF
                     for b in (min(32, max(0, 2 * k - 32 * j)) for j in range(w))], np.uint32)
    real = (pay >> 17) & 1 == 1
    words[real] = (words[real] & ~keep) | (one & keep)
    _sort_equal(dev, _to(dev, words, pay, pos), 2 * k)


def test_sort_scratch_bytes_match_the_kernel(dev):
    lib = build.lib()
    for n in (0, 1, TILE, TILE + 1, 64_487_424):
        for passes in (1, 4, 7, 8, 26, 152):
            assert lib.tp_sort_scratch_bytes(n, passes) == sort.scratch_bytes(n, passes)


@pytest.mark.parametrize("k", [25, 33])
def test_sort_allocations_within_work_bytes(dev, monkeypatch, k):
    """Every tensor the wrapper allocates beyond its outputs fits
    sort.work_bytes, which sortpipe.slot_bytes counts."""
    w = -(-2 * k // 32)
    m = 1_000_003
    args = _to(dev, *_random_records(np.random.default_rng(k), m, w))
    sizes = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        t = empty(*a, **kw)
        sizes.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    out = sort.sort_records(*args, key_bits=2 * k)
    monkeypatch.undo()
    outputs = sum(t.numel() * t.element_size() for t in out)
    assert outputs < sum(sizes) <= outputs + sort.work_bytes(m, w)


@pytest.mark.parametrize("m,w", [(1, 2), (5000, 2), (200_001, 2), (40_000, 7)])
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_kernel(dev, m, w, abundance):
    rng = np.random.default_rng(m * 7 + w)
    sw, spay, spos = sort.sort_records_plain(
        *_to(dev, *_random_records(rng, m, w, dup_frac=0.8)), key_bits=32 * w
    )
    build.reset_launch_counts()
    got = judge.judge_compact(sw, spay, spos, abundance)
    assert build.launch_counts() == {"judge_compact": 1}
    want = judge.judge_compact_plain(sw, spay, spos, abundance)
    assert got[3:] == want[3:]
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)


def test_kernels_on_genome_records(dev):
    """record build -> sort -> judge at a realistic mix of groups."""
    rng = np.random.default_rng(3)
    k, B, P = 25, 64, 2048
    p, m, v = _genome_batch(rng, B, P, k, n_rate=0.001)
    recs = records.build_sort_records(*_to(dev, p, m, v), 0, k=k, P=P)
    srt = sort.sort_records(*recs, key_bits=2 * k)
    for a, b in zip(srt, sort.sort_records_plain(*recs, key_bits=2 * k)):
        assert _equal(a, b)
    got = judge.judge_compact(*srt)
    want = judge.judge_compact_plain(*srt)
    assert got[4] > 0 and got[3:] == want[3:]
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)


def test_empty_round(dev):
    e32 = torch.empty(0, dtype=torch.uint32, device=dev)
    words = torch.empty((0, 2), dtype=torch.uint32, device=dev)
    pos = torch.empty(0, dtype=torch.int64, device=dev)
    sw, spay, spos = sort.sort_records(words, e32, pos, key_bits=50)
    assert sw.shape == (0, 2)
    assert judge.judge_compact(sw, spay, spos)[3:] == (0, 0, 0)


@pytest.mark.parametrize("k", [25, 101])
def test_pipeline_cuda_equals_cpu(dev, tmp_path, k):
    rng = np.random.default_rng(11)
    base = oracle.generate_sequence(rng, 5000)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(3)]
    sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
    cfg = PipelineConfig(k=k, positions_per_row=256, rows_per_batch=8)
    outs = []
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.dbg")
        build.reset_launch_counts()
        build_junctions_sorted(None, cfg, out, sequences=sequences, device=device)
        outs.append(open(out, "rb").read())
        if device == "cuda":
            counts = build.launch_counts()
            assert set(counts) == {"upload_rows", "build_records", "sort_records",
                                   "judge_compact", "sort_occurrences", "emit_check",
                                   "emit_chunk"}
    assert outs[0] == outs[1] and len(outs[0]) > 0


def _upload_batches(dev, rng, nb, B, P, k):
    return [_to(dev, *_genome_batch(rng, B, P, k)) for _ in range(nb)]


# k, rounds, cap, gate, rows a batch, batches, whether a round overflows
# the cap: one batch of 8 x 512 positions; then tables of batches of 64 x
# 2048 positions (64 look-back tiles a batch rolled, 512 at w > 4): the
# ballot (32 rounds) and match-mask (33, 4096) ranks, w > 4, and caps far
# below a round's count; None: rows * P, no round overflows
PART_CASES = [
    (25, 4, 1200, "full", 8, 1, False), (25, 1, 5000, "full", 8, 1, False),
    (11, 7, 150, "full", 8, 1, True), (33, 5, 900, "narrow", 8, 1, False),
    (101, 3, 64, "full", 8, 1, True), (25, 300, 8, "full", 8, 1, True),
    (25, 4, None, "full", 64, 4, False), (25, 4, 5_000, "full", 64, 3, True),
    (25, 32, None, "full", 64, 3, False), (11, 33, None, "narrow", 64, 3, False),
    (25, 4096, 8, "full", 64, 2, True), (101, 33, None, "full", 64, 2, False),
    (101, 4, 1_000, "narrow", 64, 2, True),
]


def _partition_both(dev, k, n_parts, cap, gate, rows, nb, seed):
    """-> (kernel blocks and counts, plain ones, launch counts of the
    kernel's call): partition_batch for one batch, partition_scan's table
    for more; counts as numpy int64"""
    rng = np.random.default_rng(seed)
    P = 512 if rows == 8 else 2048
    cap = rows * P if cap is None else cap
    uploads = _upload_batches(dev, rng, nb, rows, P, k)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    bounds = np.append(np.sort(rng.integers(low, high, size=n_parts - 1)), high)
    build.reset_launch_counts()
    if nb == 1:
        highs = pack.as_u32(torch.tensor(bounds, device=dev))
        got = partition.partition_batch(*uploads[0], highs, low, high, k=k, P=P, part_cap=cap)
        launches = build.launch_counts()
        want = partition.partition_batch_plain(*uploads[0], highs, low, high, k=k, P=P,
                                               part_cap=cap)
        return (*got[:3], got[3].cpu().numpy()), (*want[:3], want[3].cpu().numpy()), launches
    got = partition.partition_scan(uploads, bounds.tolist(), low, high, k=k, P=P, part_cap=cap)
    launches = build.launch_counts()
    want = partition.partition_scan_plain(uploads, bounds.tolist(), low, high, k=k, P=P,
                                          part_cap=cap)
    return got, want, launches


@pytest.mark.parametrize("k,n_parts,cap,gate,rows,nb,over", PART_CASES)
def test_partition_kernel(dev, k, n_parts, cap, gate, rows, nb, over):
    """Blocks, counts and sentinel slots equal the plain version exactly,
    one call (one launch and a tail) for a batch or a table of them,
    overflowing caps included."""
    got, want, launches = _partition_both(dev, k, n_parts, cap, gate, rows, nb,
                                          k * 31 + n_parts + nb)
    assert launches == {"partition": 1}
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)
    assert np.array_equal(got[3], want[3]) and want[3].sum() > 0
    assert (want[3] > got[0].shape[-2]).any() == over


def test_partition_scan_splits_by_status_budget(dev, monkeypatch):
    """A table whose look-back status passes STATUS_BUDGET goes in several
    calls (here one batch a call), each exact."""
    monkeypatch.setattr(partition, "STATUS_BUDGET", 64 * 33 * 8 + 8)
    got, want, launches = _partition_both(dev, 25, 33, 5_000, "full", 64, 3, 5)
    assert launches == {"partition": 3}
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)
    assert np.array_equal(got[3], want[3])


@pytest.mark.parametrize("w_k", [11, 25, 101])
def test_assemble_kernel(dev, w_k):
    rng = np.random.default_rng(w_k)
    B, P, nb, n_parts, cap = 4, 256, 3, 3, 400
    highs = pack.as_u32(torch.tensor([1 << 30, 2 << 30, 0xFFFFFFFF], device=dev))
    parts = [
        partition.partition_batch_plain(*u, highs, 0, 0xFFFFFFFF, k=w_k, P=P, part_cap=cap)
        for u in _upload_batches(dev, rng, nb, B, P, w_k)
    ]
    blocks = [torch.stack([p[j] for p in parts]) for j in range(3)]
    bases = torch.tensor([0, 1 << 33, (1 << 33) + B * P], dtype=torch.int64, device=dev)
    for r in range(n_parts):
        for buf_slots in (nb * cap, nb * cap + 777):
            build.reset_launch_counts()
            got = partition.assemble_round(r, *blocks, bases, buf_slots)
            assert build.launch_counts() == {"assemble": 1}
            want = partition.assemble_round_plain(r, *blocks, bases, buf_slots)
            for a, b in zip(got, want):
                assert _equal(a, b)


@pytest.mark.parametrize("k", [25, 101])
# 100 and 4000 overflow; 256 rows of 256 positions: 64 look-back tiles a call
@pytest.mark.parametrize("rows,slots_per_batch", [(4, 100), (4, 2048), (256, 4000), (256, 70_000)])
def test_compact_kernel(dev, k, rows, slots_per_batch):
    """compact_append over several batches whose real and other rows mix
    (the narrow gate): the buffer and the (offset, overflow) state equal
    the plain version's exactly."""
    B, P, nb = rows, 256, 5
    n = B * P
    buf_slots = nb * slots_per_batch + n
    low, high = 1 << 30, 3 << 30
    outs = []
    for fn in (stream.compact_append, stream.compact_append_plain):
        rng_b = np.random.default_rng(7)
        buf, state = stream.new_round_buffer(buf_slots, pack.n_words(k), dev)
        build.reset_launch_counts()
        for bi, u in enumerate(_upload_batches(dev, rng_b, nb, B, P, k)):
            recs = records.build_sort_records_plain(*u, bi * n, k=k, P=P, low=low, high=high)
            fn(*recs, buf, state, buf_slots - n)
        if fn is stream.compact_append:
            assert build.launch_counts() == {"compact": nb}
        outs.append((*buf, state))
    for a, b in zip(*outs):
        assert _equal(a, b)
    assert int(outs[0][3][1]) == (slots_per_batch in (100, 4000))


@pytest.mark.parametrize("real", ["all", "none"])
def test_compact_kernel_all_or_none_real(dev, real):
    """Every row real, or none, over 20 tiles, appended twice; the empty
    call launches nothing and changes nothing."""
    words, pay, pos = _random_records(np.random.default_rng(len(real)), 20_000, 2,
                                      sent_frac=0.0)
    if real == "none":
        pay[:] = 0
    recs = _to(dev, words, pay, pos)
    outs = []
    for fn in (stream.compact_append, stream.compact_append_plain):
        buf, state = stream.new_round_buffer(60_000, 2, dev)
        build.reset_launch_counts()
        for _ in range(2):
            fn(*recs, buf, state, 40_000)
        fn(*(t[:0] for t in recs), buf, state, 40_000)
        if fn is stream.compact_append:
            assert build.launch_counts() == {"compact": 2}
        outs.append((*buf, state))
    for a, b in zip(*outs):
        assert _equal(a, b)
    assert outs[0][3].tolist() == [40_000 if real == "all" else 0, 0]


# One torch.profiler session a process records device events (a second
# one in the process records none), so the device kernels of the partition
# and the compaction are listed in a child process of their own
LAUNCH_CHILD = r"""
import json
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import lookup, partition, records, stream

dev = torch.device("cuda")
rng = np.random.default_rng(3)
k, B, P = 25, 64, 2048

def batch():
    codes = rng.integers(0, 4, size=(B, P + k + 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.001] = 4
    return [torch.from_numpy(a).to(dev) for a in (*pack.pack_codes_host(codes),
                                                 np.full(B, P, np.int32))]

ups = [batch() for _ in range(5)]
bounds = [1 << 30, 2 << 30, 3 << 30, 0xFFFFFFFF]
highs = pack.as_u32(torch.tensor(bounds, device=dev))
recs = records.build_sort_records(*ups[0], 0, k=k, P=P, low=1 << 30, high=3 << 30)
buf, state = stream.new_round_buffer(4 * B * P, pack.n_words(k), dev)
table = torch.from_numpy(np.unique(pack.as_i64(recs[0]).cpu().numpy()[::3], axis=0)
                         .astype(np.uint32)).to(dev)
masks = [torch.from_numpy(rng.integers(0, 256, size=(B, P // 8)).astype(np.uint8)).to(dev)
         for _ in ups]
calls = (
    lambda: partition.partition_scan(ups, bounds, 0, 0xFFFFFFFF, k=k, P=P, part_cap=40_000),
    lambda: partition.partition_batch(*ups[0], highs, 0, 0xFFFFFFFF, k=k, P=P, part_cap=40_000),
    lambda: stream.compact_append(*recs, buf, state, 3 * B * P),
    lambda: lookup.pass4_lookup_batches(ups, masks, table, 5 * B * P, [i * B * P for i in range(5)],
                                        k=k, P=P, id_bits=32),
)
for fn in calls:  # the kept scratch allocated, the library loaded
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
names = {}
for e in prof.key_averages():
    if e.device_type == DeviceType.CUDA:
        name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        names[name.split("(")[0].strip()] = e.count
print("LAUNCHES " + json.dumps(names))
"""


def test_partition_compact_device_launches(dev):
    """One partition_scan over a table of 5 batches, one partition_batch,
    one compact_append and one pass4_lookup_batches over 5 batches launch
    two kernels each (k_partition and k_part_tail, k_compact_real and
    k_compact_rest, k_lookup and k_lookup_tail), and no scan kernel, no
    memset and nothing else: copies only."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run([sys.executable, "-c", LAUNCH_CHILD], cwd=root, capture_output=True,
                           text=True, timeout=600)
    lines = [line for line in child.stdout.splitlines() if line.startswith("LAUNCHES ")]
    assert child.returncode == 0 and lines, child.stdout[-2000:] + child.stderr[-2000:]
    names = json.loads(lines[-1][len("LAUNCHES "):])
    kernels = {n: c for n, c in names.items() if not n.startswith("Memcpy")}
    assert kernels == {"k_partition<2>": 2, "k_part_tail": 2, "k_compact_real<2>": 1,
                       "k_compact_rest<2>": 1, "k_lookup<2>": 1, "k_lookup_tail": 1}, names


@pytest.mark.parametrize("k", [11, 25, 101])
@pytest.mark.parametrize("stride", [1, 4])
def test_histogram_kernel(dev, k, stride):
    rng = np.random.default_rng(k * stride)
    B, P = 16, 2048
    args = _to(dev, *_genome_batch(rng, B, P, k))
    build.reset_launch_counts()
    got = histogram.histogram_vertex_hashes(*args, k=k, P=P, stride=stride)
    got = histogram.histogram_vertex_hashes(*args, k=k, P=P, stride=stride, out=got)
    assert build.launch_counts() == {"histogram": 2}
    want = histogram.histogram_vertex_hashes_plain(*args, k=k, P=P, stride=stride)
    assert torch.equal(got.cpu(), 2 * want.cpu()) and int(want.sum()) > 0
    # the batched entry: one launch over 5 batches, one with no valid position
    uploads = _five_batches(dev, rng, B, P, k)
    build.reset_launch_counts()
    got = histogram.histogram_vertex_hashes_batches(uploads, k=k, P=P, stride=stride)
    assert build.launch_counts() == {"histogram": 1}
    want = histogram.histogram_vertex_hashes_batches_plain(uploads, k=k, P=P, stride=stride)
    assert torch.equal(got.cpu(), want.cpu()) and int(want.sum()) > 0
    scan = histogram.histogram_scan(uploads, k=k, P=P, stride=stride)
    assert np.array_equal(scan, want.cpu().numpy())


def _five_batches(dev, rng, B, P, k):
    """Five uploaded batches (their own valid counts), batch 2 with no
    valid position."""
    uploads = _upload_batches(dev, rng, 5, B, P, k)
    uploads[2][2].zero_()
    return uploads


@pytest.mark.parametrize("word0", [False, True])
def test_histogram_kernel_one_bin(dev, word0):
    """An all-A genome puts every position in one bin: 32 batches of 256
    rows x 2048 in one call (past 65,535 positions a block between its
    flushes, 2^24 in the bin), equal to the plain version."""
    B, P, k = 256, 2048, 25
    codes = np.zeros((B, P + k + 1), np.uint8)
    p, m = pack.pack_codes_host(codes)
    batch = _to(dev, p, m, np.full(B, P, np.int32))
    uploads = [batch] * 32
    fn, plain, name = (
        (histogram.word0_histogram_batches, histogram.word0_histogram_batches_plain,
         "word0_histogram") if word0 else
        (histogram.histogram_vertex_hashes_batches,
         histogram.histogram_vertex_hashes_batches_plain, "histogram"))
    build.reset_launch_counts()
    got = fn(uploads, k=k, P=P)
    assert build.launch_counts() == {name: 1}
    want = plain(uploads, k=k, P=P)
    assert torch.equal(got.cpu(), want.cpu())
    assert int(want.max()) == 32 * B * P == int(want.sum())


MODES = {
    "resident": ({}, {"partition", "assemble"}),
    "grouped": ({"TWOPACO_RESIDENT_BYTES": "1"}, {"partition", "assemble"}),
    "stream": ({"TWOPACO_RESIDENT": "0", "TWOPACO_GROUPED": "0"}, {"build_records", "compact"}),
    "histogram": ({"TWOPACO_UNIFORM_SPLIT": "0"}, {"partition", "assemble", "histogram"}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_rounds_cuda_equals_cpu(dev, tmp_path, monkeypatch, mode):
    env, kernels = MODES[mode]
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    rng = np.random.default_rng(12)
    base = oracle.generate_sequence(rng, 6000)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(3)]
    sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
    cfg = PipelineConfig(k=25, rounds=3, positions_per_row=256, rows_per_batch=8)
    outs = []
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.dbg")
        build.reset_launch_counts()
        build_junctions_sorted(None, cfg, out, sequences=sequences, device=device)
        outs.append(open(out, "rb").read())
        if device == "cuda":
            counts = build.launch_counts()
            assert kernels | {"sort_records", "judge_compact"} <= set(counts), counts
    assert outs[0] == outs[1] and len(outs[0]) > 0


# ---- the Bloom engine -------------------------------------------------

BLOOM_CASES = [  # (layout, f, k): f = 34 takes the 64-bit probe indices
    ("byte", 20, 25), ("bit", 20, 25), ("bit", 34, 25), ("block", 20, 25),
    ("byte", 18, 101), ("bit", 16, 11), ("block", 16, 7), ("block", 12, 33),
]


def _filters_equal(a, b):
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("layout,f,k", BLOOM_CASES)
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_bloom_fill_mark_kernels(dev, layout, f, k, gate):
    """The filter after fill and the mask and count of mark equal the
    plain versions' exactly."""
    rng = np.random.default_rng(f * 7 + k)
    B, P = 16, 512
    args = _to(dev, *_genome_batch(rng, B, P, k))
    cfg = PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=B)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    build.reset_launch_counts()
    got = fill.bloom_fill(bloom.make_filter(f, layout, dev), *args, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_fill": 1}
    want = fill.bloom_fill_plain(bloom.make_filter(f, layout, dev), *args, low, high, cfg=cfg)
    assert _filters_equal(got, want) and bool(want.view(torch.uint8).any())
    build.reset_launch_counts()
    mk, ck = mark.bloom_mark(got, *args, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_mark": 1}
    mp, cp = mark.bloom_mark_plain(got, *args, low, high, cfg=cfg)
    assert torch.equal(mk, mp) and int(ck) == int(cp) > 0


# (layout, f): the slice's byte and block filters (f = 30), bit at f = 34
# and 35 (64-bit indices; 35 is the layout's largest), and small filters
# whose many set slots send most first-slot hits on to the later slots
BLOOM_ROUND_CASES = [("byte", 30), ("bit", 34), ("bit", 35), ("block", 30), ("byte", 14),
                     ("block", 12)]


@pytest.mark.parametrize("layout,f", BLOOM_ROUND_CASES)
@pytest.mark.parametrize("k", [25, 101, 129])
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_bloom_round_kernels(dev, layout, f, k, gate):
    """bloom_fill_batches and bloom_mark_batches: one launch each over a
    table of uneven batches (row counts 16, 8, 16, 3 and a short last batch
    of 1; N runs, short valid counts, a row of valid 0): the filter equal
    to the per-batch plain fill's bit for bit, every mask and count equal
    to the per-batch plain mark's."""
    rng = np.random.default_rng(f * 1000 + k * 3 + len(gate))
    P = 512
    rows = [16, 8, 16, 3, 1]
    uploads = [_to(dev, *_n_run_batch(rng, r, P, k, n_runs=6 if k <= 101 else 2))
               for r in rows]
    cfg = PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=16)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    build.reset_launch_counts()
    got = fill.bloom_fill_batches(bloom.make_filter(f, layout, dev), uploads, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_fill": 1}
    want = fill.bloom_fill_batches_plain(bloom.make_filter(f, layout, dev), uploads, low, high,
                                         cfg=cfg)
    assert _filters_equal(got, want) and bool(want.view(torch.uint8).any())
    del want
    build.reset_launch_counts()
    mk, ck = mark.bloom_mark_batches(got, uploads, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_mark": 1}
    mp, cp = mark.bloom_mark_batches_plain(got, uploads, low, high, cfg=cfg)
    assert [m.shape for m in mk] == [(r, P // 8) for r in rows]
    for a, b in zip(mk, mp):
        assert torch.equal(a, b)
    assert torch.equal(ck, cp) and int(cp.sum()) > 0


@pytest.mark.parametrize("run", [8, 4, 2])
@pytest.mark.parametrize("layout,f", [("byte", 30), ("bit", 34), ("bit", 35), ("block", 30)])
@pytest.mark.parametrize("k", [25, 101, 129])
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_bloom_round_kernels_runs(dev, run, layout, f, k, gate):
    """The round entries where a thread rolls along runs of 8, 4 and 2
    positions: batches sized so that the card's grid takes that run (1.5
    times the rows whose threads would give every SM 1024 at it). The
    rolled hashes, the window's last N across steps, the block fill's carry
    of V_next's edge into the next position and the packing of a run's
    decisions, over uneven batches with N runs, a valid-0 row in each and a
    1-row last batch: the filter equal to the plain fill's bit for bit, every
    mask and count equal to the plain mark's."""
    P, nb = 512, 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    R = int(1.5 * 1024 * sms * run / (nb * P))
    assert build.lib().tp_bloom_run(R * P, nb) == run
    rng = np.random.default_rng(run * 100_000 + f * 1000 + k * 3 + len(gate))
    rows = [R, R // 2 + 1, R, 1]
    uploads = [_to(dev, *_n_run_batch(rng, r, P, k, n_runs=6 if k <= 101 else 2))
               for r in rows]
    cfg = PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=R)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    build.reset_launch_counts()
    got = fill.bloom_fill_batches(bloom.make_filter(f, layout, dev), uploads, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_fill": 1}
    want = fill.bloom_fill_batches_plain(bloom.make_filter(f, layout, dev), uploads, low, high,
                                         cfg=cfg)
    assert _filters_equal(got, want) and bool(want.view(torch.uint8).any())
    del want
    build.reset_launch_counts()
    mk, ck = mark.bloom_mark_batches(got, uploads, low, high, cfg=cfg)
    assert build.launch_counts() == {"bloom_mark": 1}
    mp, cp = mark.bloom_mark_batches_plain(got, uploads, low, high, cfg=cfg)
    for a, b in zip(mk, mp):
        assert torch.equal(a, b)
    assert torch.equal(ck, cp) and int(cp.sum()) > 0


def test_bloom_round_kernels_refuse_f36_bit(dev):
    """f = 36 in the bit layout is past the one-device filter's cap (2^35
    slots): the round entries raise before launching (dist-bloom shards
    such a filter)."""
    rng = np.random.default_rng(36)
    uploads = [_to(dev, *_genome_batch(rng, 4, 256, 25))]
    cfg = PassConfig(k=25, f=36, layout="bit", positions_per_row=256, rows_per_batch=4)
    filt = torch.zeros(8, dtype=torch.uint32, device=dev)
    build.reset_launch_counts()
    for fn in (fill.bloom_fill_batches, mark.bloom_mark_batches):
        with pytest.raises(ValueError, match="per device"):
            fn(filt, uploads, 0, 0xFFFFFFFF, cfg=cfg)
    assert build.launch_counts() == {}


def _marked_batches(dev, k, nb, B=8, P=256, f=18):
    rng = np.random.default_rng(k + nb)
    cfg = PassConfig(k=k, f=f, layout="byte", positions_per_row=P, rows_per_batch=B)
    ups = _upload_batches(dev, rng, nb, B, P, k)
    filt = bloom.make_filter(f, "byte", dev)
    for u in ups:
        fill.bloom_fill_plain(filt, *u, 0, 0xFFFFFFFF, cfg=cfg)
    return ups, [mark.bloom_mark_plain(filt, *u, 0, 0xFFFFFFFF, cfg=cfg) for u in ups]


@pytest.mark.parametrize("k", [11, 25, 101])
@pytest.mark.parametrize("short", [0, 5])  # 5: the buffer overflows
def test_bloom_extract_kernel(dev, k, short):
    """Several batches appended: the buffer and the (offset, overflow)
    state equal the plain version's."""
    B, P, nb = 8, 256, 3
    ups, marked = _marked_batches(dev, k, nb, B, P)
    total = sum(int(c) for _m, c in marked)
    outs = []
    for fn in (extract.extract_records, extract.extract_records_plain):
        buf, state = extract.new_buffer(total - short, pack.n_words(k), dev)
        build.reset_launch_counts()
        for bi, (u, (m, _c)) in enumerate(zip(ups, marked)):
            fn(u[0], u[1], m, buf, state, (1 << 33) + bi * B * P, k=k, P=P)
        if fn is extract.extract_records:
            assert build.launch_counts() == {"bloom_extract": nb}
        outs.append((*buf, state))
    for a, b in zip(*outs):
        assert _equal(a, b)
    assert outs[0][3].tolist() == [total, int(short > 0)]


EXTRACT_CASES = {  # batch row counts, mask bit density, slots short of the count
    "one": ([16], 0.1, 0), "three": ([16, 3, 9], 0.1, 0),
    "many": ([(5 * b) % 11 + 1 for b in range(123)], 0.07, 0),
    "empty": ([16, 3, 9], 0.0, 0), "full": ([16, 3, 9], 1.0, 0),
    "short": ([16, 3, 9], 0.1, 1),
    "groups": ([(5 * b) % 11 + 1 for b in range(123)], 0.07, 1),  # 25 calls
}


@pytest.mark.parametrize("k", [25, 33, 101])
@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_bloom_extract_batches_kernel(dev, monkeypatch, k, case):
    """extract_records_batches: one call (one launch and its tail) over a
    table of 1, 3 or 123 batches of unequal row counts (8192-position
    look-back tiles across batches, rows across tiles) at ascending bases,
    appended after records already in the buffer, equal to the plain
    per-batch loop: every buffer slot and the (offset, overflow) state.
    Masks are views of one buffer, as the round mark returns them (the
    three-batch cases: separate tensors); also all-zero masks, every bit
    set (positions with N in their window and past the valid count: a
    record all the same), and a buffer one slot short, which sets the
    overflow flag. "groups": a call's positions cut to five batches'
    (extract.CALL_POSITIONS), so that the batches go in 25 calls that append
    in turn, the last past the buffer's end."""
    rows, density, short = EXTRACT_CASES[case]
    P = 512
    calls = 1
    if case == "groups":
        monkeypatch.setattr(extract, "CALL_POSITIONS", 5 * max(rows) * P)
        calls = -(-len(rows) // 5)
    rng = np.random.default_rng(k * 100 + len(case))
    uploads = [_to(dev, *_n_run_batch(rng, r, P, k)) for r in rows]
    bits = [rng.random((r, P)) < density for r in rows]
    if len(rows) == 3:
        masks = [torch.from_numpy(np.packbits(m, axis=1)).to(dev) for m in bits]
    else:
        flat = torch.from_numpy(np.concatenate([np.packbits(m, axis=1).reshape(-1)
                                                for m in bits])).to(dev)
        masks = [v.view(r, P // 8) for v, r in zip(flat.split([r * P // 8 for r in rows]),
                                                   rows)]
    bases = list(np.cumsum([0] + [(r + 2) * P for r in rows[:-1]]) + (1 << 33))
    pre = 5  # records appended before the call
    total = pre + sum(int(m.sum()) for m in bits)
    outs = []
    for fn in (extract.extract_records_batches, extract.extract_records_batches_plain):
        buf, state = extract.new_buffer(total - short, pack.n_words(k), dev)
        for t in buf:
            t.view(torch.uint8).fill_(0xA5)  # slots no record writes stay so
        state[0] = pre
        build.reset_launch_counts()
        fn(uploads, masks, buf, state, bases, k=k, P=P)
        if fn is extract.extract_records_batches:
            assert build.launch_counts() == {"bloom_extract": calls}
        outs.append((*buf, state))
    for a, b in zip(*outs):
        assert _equal(a, b)
    assert outs[0][3].tolist() == [total, int(short > 0)]
    assert (total == pre) == (case == "empty")


@pytest.mark.parametrize("k", [11, 25, 101])
@pytest.mark.parametrize("table", ["all", "half", "empty"])
def test_bloom_lookup_kernel(dev, k, table):
    B, P = 8, 256
    ups, marked = _marked_batches(dev, k, 1, B, P)
    (u,), ((m, c),) = ups, marked
    count = int(c)
    buf, _state = extract.extract_records_plain(
        u[0], u[1], m, *extract.new_buffer(count, pack.n_words(k), dev), 0, k=k, P=P)
    tab = judge.judge_compact_plain(*sort.sort_records_plain(*buf, key_bits=2 * k))[0]
    tab = {"all": tab, "half": tab[::2].contiguous(), "empty": tab[:0]}[table]
    for cap in (count, max(1, count // 3)):  # a short cap keeps the first hits
        build.reset_launch_counts()
        got = lookup.pass4_lookup(*u, m, tab, cap, k=k, P=P, id_bits=32)
        assert build.launch_counts() == ({} if table == "empty" else {"bloom_lookup": 1})
        want = lookup.pass4_lookup_batches_plain([u], [m], tab, cap, [0], k=k, P=P, id_bits=32)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
    assert (int(want[1]) > 0) == (table != "empty")


def _lookup_case(dev, k, rows, P, seed, density=0.4):
    """Batches of `rows` rows (N runs, short and zero valid counts) on dev,
    random masks of the given bit density, their bases (ascending, a gap
    after the first), and a junction table of the canonical k-mers of every
    other valid position (so some candidates hit, some miss)."""
    rng = np.random.default_rng(seed)
    uploads = [_to(dev, *_n_run_batch(rng, r, P, k)) for r in rows]
    masks = [torch.from_numpy(np.packbits(rng.random((r, P)) < density, axis=1)).to(dev)
             for r in rows]
    bases, b0 = [], 0
    for i, r in enumerate(rows):
        bases.append(b0)
        b0 += (r + (7 if i == 0 else 0)) * P
    keys = []
    for up in uploads:
        canon, _pay, _hv, ok = records.batch_records_plain(*(t.cpu() for t in up), k=k, P=P)
        keys.append(canon[ok].numpy()[::2])
    table = np.unique(np.concatenate(keys), axis=0).astype(np.uint32)
    return uploads, masks, bases, torch.from_numpy(table).to(dev)


def _lookup_both(uploads, masks, table, cap, bases, k, P, id_bits=32):
    """The kernel's keys and count equal the plain version's (its keys
    ascending). -> the count."""
    build.reset_launch_counts()
    got = lookup.pass4_lookup_batches(uploads, masks, table, cap, bases, k=k, P=P,
                                      id_bits=id_bits)
    assert build.launch_counts() == {"bloom_lookup": 1}
    want = lookup.pass4_lookup_batches_plain(uploads, masks, table, cap, bases, k=k, P=P,
                                             id_bits=id_bits)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    n = min(int(want[1]), cap)
    assert (np.diff(want[0][:n].cpu().numpy().view(np.uint64)) > 0).all()
    return int(want[1])


@pytest.mark.parametrize("k", [11, 25, 33, 49, 101])
@pytest.mark.parametrize("case", ["uneven", "odd_rows", "one_junction", "zero_mask",
                                  "cap_exact", "cap_short", "dense"])
def test_bloom_lookup_batches_kernel(dev, k, case):
    """pass4_lookup_batches: one call (one launch and its tail) over a table
    of batches with different row counts at ascending bases with a gap,
    equal to the plain per-batch loop: positions, ids, count and padding.
    Batches of 16 rows of 512 positions hold two 4096-position tiles, 264
    positions a row puts rows across tile edges; hits cross tiles and
    batches. Also a one-row table (J = 1), an all-zero mask, cap exactly the
    hit count and below it, and every bit set. Keys of 32 id bits, and of
    the fewest the table's ids need (the positions in the rest)."""
    P = 264 if case == "odd_rows" else 512
    rows = [16, 8, 16, 3, 1]
    density = 1.0 if case == "dense" else 0.4
    uploads, masks, bases, table = _lookup_case(dev, k, rows, P, seed=k + len(case),
                                                density=density)
    if case == "one_junction":  # the row of a hit in the middle of the hits
        keys, cnt = lookup.pass4_lookup_batches_plain(uploads, masks, table, 1 << 20, bases,
                                                      k=k, P=P, id_bits=32)
        row = abs(int(keys[int(cnt) // 2] & 0xFFFFFFFF) - (1 << 31)) - 1
        table = table[row : row + 1].contiguous()
    if case == "zero_mask":
        masks = [torch.zeros_like(m) for m in masks]
    n_cand = sum(int(np.unpackbits(m.cpu().numpy()).sum()) for m in masks)
    cap = max(n_cand, 1)
    if case in ("cap_exact", "cap_short"):
        n = int(lookup.pass4_lookup_batches_plain(uploads, masks, table, cap, bases, k=k,
                                                  P=P, id_bits=32)[1])
        cap = n if case == "cap_exact" else n // 3
    n = _lookup_both(uploads, masks, table, cap, bases, k, P)
    assert _lookup_both(uploads, masks, table, cap, bases, k, P,
                        id_bits=len(table).bit_length() + 1) == n
    assert (n == 0) == (case == "zero_mask")
    if case == "one_junction":
        assert n > 0


@pytest.mark.parametrize("spill", [False, True])
def test_bloom_lookup_batches_rounds(dev, monkeypatch, tmp_path, spill):
    """Two rounds' masks through bloompipe.MaskStore, kept on the card or
    spilled to files (then a group of two batches a call, as the Bloom
    engine's pass 4 makes them): each group's call equals the plain version
    on the rounds' OR."""
    from twopaco_tpu_torch.passes import bloompipe

    k, P, rows = 25, 512, [8, 8, 8, 8, 8]
    uploads, masks, bases, table = _lookup_case(dev, k, rows, P, seed=2 + spill)
    rng = np.random.default_rng(9)
    other = [torch.from_numpy(np.packbits(rng.random((r, P)) < 0.1, axis=1)).to(dev)
             for r in rows]
    batch_bytes = 8 * P // 8
    monkeypatch.setenv("TWOPACO_MASK_SPILL_BYTES", str(2 * batch_bytes if spill else 1 << 30))
    store = bloompipe.MaskStore(str(tmp_path), est_bytes=2 * len(rows) * batch_bytes)
    store.add_round(masks)
    store.add_round(other)
    per = min(store.group_size(batch_bytes), len(rows))
    assert per == (2 if spill else len(rows))
    total = 0
    for g0 in range(0, len(rows), per):
        g1 = min(g0 + per, len(rows))
        got = store.group_masks(g0, g1, dev)
        want = [a | b for a, b in zip(masks[g0:g1], other[g0:g1])]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        cap = sum(int(np.unpackbits(m.cpu().numpy()).sum()) for m in want)
        total += _lookup_both(uploads[g0:g1], got, table, cap, bases[g0:g1], k, P)
        _lookup_both(uploads[g0:g1], got, table, cap, bases[g0:g1], k, P, id_bits=40)
    store.cleanup()
    assert total > 0


def test_bloom_wrappers_never_reach_the_plain_code(dev, monkeypatch):
    """A CUDA tensor given to a Bloom wrapper launches its kernel: the
    plain versions, made to raise here, are never called."""
    def boom(*a, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((fill, "bloom_fill_plain"), (mark, "bloom_mark_plain"),
                      (fill, "bloom_fill_batches_plain"), (mark, "bloom_mark_batches_plain"),
                      (extract, "extract_records_plain"),
                      (extract, "extract_records_batches_plain"), (lookup, "pass4_lookup_plain"),
                      (lookup, "pass4_lookup_batches_plain")):
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(5)
    k, B, P = 25, 8, 256
    u = _to(dev, *_genome_batch(rng, B, P, k))
    build.reset_launch_counts()
    for layout, f in (("byte", 18), ("bit", 18), ("block", 18)):
        cfg = PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=B)
        filt = fill.bloom_fill(bloom.make_filter(f, layout, dev), *u, 0, 0xFFFFFFFF, cfg=cfg)
        fill.bloom_fill_batches(filt, [u, u], 0, 0xFFFFFFFF, cfg=cfg)
        mark.bloom_mark_batches(filt, [u, u], 0, 0xFFFFFFFF, cfg=cfg)
        m, c = mark.bloom_mark(filt, *u, 0, 0xFFFFFFFF, cfg=cfg)
    buf, state = extract.extract_records(
        u[0], u[1], m, *extract.new_buffer(int(c), pack.n_words(k), dev), 0, k=k, P=P)
    extract.extract_records_batches([u, u], [m, m], *extract.new_buffer(2 * int(c),
                                                                        pack.n_words(k), dev),
                                    [0, B * P], k=k, P=P)
    tab = judge.judge_compact(*sort.sort_records(*buf, key_bits=2 * k))[0]
    lookup.pass4_lookup(*u, m, tab, int(c), k=k, P=P, id_bits=32)
    lookup.pass4_lookup_batches([u, u], [m, m], tab, 2 * int(c), [0, B * P], k=k, P=P,
                                id_bits=32)
    assert build.launch_counts() == {
        "bloom_fill": 6, "bloom_mark": 6, "bloom_extract": 2, "sort_records": 1,
        "judge_compact": 1, "bloom_lookup": 2,
    }


@pytest.mark.parametrize("layout,rounds,k", [
    ("byte", 1, 25), ("bit", 3, 25), ("block", 2, 101), ("byte", 3, 11),
])
def test_bloom_pipeline_cuda_equals_cpu(dev, tmp_path, layout, rounds, k):
    rng = np.random.default_rng(13)
    base = oracle.generate_sequence(rng, 6000)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(3)]
    sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
    cfg = PipelineConfig(k=k, rounds=rounds, filter_bits=20, layout=layout, engine="bloom",
                         positions_per_row=256, rows_per_batch=8)
    outs = []
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.dbg")
        build.reset_launch_counts()
        with trace.span("twopaco") as root:
            enum = build_junctions(None, cfg, out, sequences=sequences, device=device)
        outs.append(open(out, "rb").read())
        if device == "cuda":  # the card emit: every record but the separators built there
            counts = build.launch_counts()
            assert set(counts) == {
                "upload_rows", "bloom_fill", "bloom_mark", "bloom_extract", "sort_records",
                "judge_compact", "bloom_lookup", "emit_check", "emit_chunk",
            }
            for name in ("bloom_fill", "bloom_mark", "bloom_extract"):
                assert counts[name] == rounds  # one a round
            assert counts["bloom_lookup"] == 1  # one call a run
            assert counts["emit_check"] == 1 and counts["emit_chunk"] >= 1
            assert _emit_write(root).counters["card_records"] == enum.stats.occurrences > 0
    sort_out = str(tmp_path / "sort.dbg")
    build_junctions_sorted(None, cfg, sort_out, sequences=sequences, device="cuda")
    assert outs[0] == outs[1] == open(sort_out, "rb").read() and len(outs[0]) > 0


# ---- the distributed engine's kernels (route, judge_records, word0
# histogram, occurrence sort) and the engine on a 4-shard LocalMesh


@pytest.mark.parametrize("m,w,D,bounds,cap,skew", [
    (70_001, 2, 4, False, 30_000, ""), (70_001, 2, 4, True, 30_000, ""),
    (70_001, 2, 4, True, 9_000, ""), (100_003, 1, 8, False, 20_000, ""),
    (30_011, 7, 3, True, 12_000, ""), (0, 2, 4, False, 128, ""), (5_000, 2, 1, True, 6_000, ""),
    # the match-mask ranks (past 32 owners), TP_ROUTE_MAX owners, one record
    (50_000, 2, 33, True, 2_000, ""), (50_000, 2, 33, False, 1_000, ""),
    (60_000, 2, 4096, True, 40, ""), (60_000, 1, 4096, False, 8, ""), (1, 2, 4, True, 128, ""),
    # every real record owned by shard 2, far past its cap
    (131_072, 2, 4, True, 5_000, "one_owner"),
])
def test_route_kernel(dev, m, w, D, bounds, cap, skew):
    """Send buffers and the overflow count equal the plain version's
    exactly; the count is each owner's records past cap (some cases
    overflow)."""
    rng = np.random.default_rng(m + D)
    words_np, pay_np, pos_np = _random_records(rng, m, w)
    if skew == "one_owner":
        words_np[:, 0] = np.uint32(0x90000000)  # between cuts 1 and 2 below
    words, pay, pos = _to(dev, words_np, pay_np, pos_np)
    bnd = None
    w0 = words_np[:, 0].astype(np.int64)
    owner = (w0 * D) >> 32
    if bounds:
        cuts = np.sort(rng.choice(1 << 32, size=D - 1, replace=False)).astype(np.int64)
        if skew == "one_owner":
            cuts = np.array([1 << 30, 1 << 31, 3 << 30], np.int64)
        bnd = pack.as_u32(torch.tensor(cuts, device=dev))
        owner = np.searchsorted(cuts, w0, side="left")
    per_owner = np.bincount(owner[(pay_np >> 17) & 1 == 1], minlength=D)
    dropped = int(np.maximum(per_owner - cap, 0).sum())
    over = torch.full((1,), 5, dtype=torch.int64, device=dev)
    build.reset_launch_counts()
    got = route.route_records(words, pay, pos, D, cap, bounds=bnd, overflow=over.clone())
    assert build.launch_counts() == {"route": 1}
    want = route.route_records_plain(words, pay, pos, D, cap, bounds=bnd, overflow=over.clone())
    for a, b in zip(got, want):
        assert _equal(a, b)
    assert int(want[3]) == 5 + dropped
    if skew == "one_owner":
        assert dropped == int(per_owner[2]) - cap > 0


@pytest.mark.parametrize("D,bounds", [(4, True), (4, False), (33, True)])
def test_route_kernel_reuses_out(dev, D, bounds):
    """Two calls into the same send buffers, the first overflowing: the
    second's buffers and count equal the plain version's (the look-back's
    epoch-tagged status words need no clearing between calls)."""
    rng = np.random.default_rng(D + 77)
    cap = 2_000
    bnd = None
    if bounds:
        cuts = np.sort(rng.choice(1 << 32, size=D - 1, replace=False)).astype(np.int64)
        bnd = pack.as_u32(torch.tensor(cuts, device=dev))
    first = _to(dev, *_random_records(rng, 100_000, 2))
    second = _to(dev, *_random_records(rng, 2_000, 2))  # never past cap
    out = route.new_send(D, cap, 2, dev)
    build.reset_launch_counts()
    got1 = route.route_records(*first, D, cap, bounds=bnd, out=out)
    got2 = route.route_records(*second, D, cap, bounds=bnd, out=out)
    assert build.launch_counts() == {"route": 2}
    assert all(g is o for g, o in zip(got2[:3], out))
    want1 = route.route_records_plain(*first, D, cap, bounds=bnd)
    want2 = route.route_records_plain(*second, D, cap, bounds=bnd)
    assert int(got1[3]) == int(want1[3]) > 0 and int(got2[3]) == int(want2[3]) == 0
    for a, b in zip(got2, want2):
        assert _equal(a, b)


@pytest.mark.parametrize("m,w", [(1, 2), (5000, 2), (200_001, 2), (40_000, 7)])
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_records_kernel(dev, m, w, abundance):
    rng = np.random.default_rng(m * 5 + w)
    sw, spay, _spos = sort.sort_records_plain(*_to(dev, *_random_records(rng, m, w, dup_frac=0.8)),
                                              key_bits=32 * w)
    build.reset_launch_counts()
    got = judge.judge_records(sw, spay, abundance)
    assert build.launch_counts() == {"judge_records": 1}
    want = judge.judge_records_plain(sw, spay, abundance)
    assert got[3:] == want[3:]
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)


@pytest.mark.parametrize("k", [11, 25, 33, 101])
def test_word0_histogram_kernel(dev, k):
    rng = np.random.default_rng(k)
    B, P = 16, 2048
    args = _to(dev, *_genome_batch(rng, B, P, k))
    build.reset_launch_counts()
    got = histogram.word0_histogram(*args, k=k, P=P)
    got = histogram.word0_histogram(*args, k=k, P=P, out=got)
    assert build.launch_counts() == {"word0_histogram": 2}
    want = histogram.word0_histogram_plain(*args, k=k, P=P)
    assert torch.equal(got.cpu(), 2 * want.cpu()) and int(want.sum()) > 0
    # the batched entry: one launch over 5 batches, one with no valid position
    uploads = _five_batches(dev, rng, B, P, k)
    build.reset_launch_counts()
    got = histogram.word0_histogram_batches(uploads, k=k, P=P, out=got.zero_())
    assert build.launch_counts() == {"word0_histogram": 1}
    want = histogram.word0_histogram_batches_plain(uploads, k=k, P=P)
    assert torch.equal(got.cpu(), want.cpu()) and int(want.sum()) > 0


@pytest.mark.parametrize("n,id_bits,pos_limit", [
    (0, 32, 1 << 32), (1, 32, 1 << 32), (4097, 32, 1 << 20), (200_001, 32, 1 << 32),
    (300_000, 31, 1 << 33), (50_000, 20, 1 << 40),
    # 0 to 6 digit passes over the position bits (an odd count builds the
    # keys in the other buffer), the slice's 4.69 M occurrences among 2^26
    # positions included
    (1, 32, 1), (200, 40, 1 << 8), (60_000, 30, 1 << 16), (70_000, 30, 1 << 17),
    (4_690_000, 32, 64_487_424), (2_000_000, 20, 1 << 44),
])
def test_sort_occurrences_kernel(dev, n, id_bits, pos_limit):
    rng = np.random.default_rng(n + id_bits)
    pos = rng.choice(pos_limit, size=n, replace=False) if pos_limit <= 1 << 33 else (
        np.unique(rng.integers(0, pos_limit, size=2 * n))[:n])
    rng.shuffle(pos)
    lid = rng.integers(1, 1 << min(id_bits - 1, 30), size=len(pos))
    ids = np.where(rng.random(len(pos)) < 0.5, -lid, lid).astype(np.int32)
    args = _to(dev, pos.astype(np.int64), ids)
    build.reset_launch_counts()
    got = occ.sort_occurrences(*args, id_bits=id_bits, pos_limit=pos_limit)
    assert build.launch_counts() == {"sort_occurrences": 1}
    want = occ.sort_occurrences_plain(*args, id_bits=id_bits, pos_limit=pos_limit)
    for a, b in zip(got, want):
        assert _equal(a, b)
    assert int(got[1]) == 0


def test_sort_occurrences_kernel_flags_bad(dev):
    pos = torch.tensor([5, 100, -1, 7, 8], dtype=torch.int64, device=dev)
    ids = torch.tensor([1, 2, 3, 0, 1 << 20], dtype=torch.int32, device=dev)
    got = occ.sort_occurrences(pos, ids, id_bits=20, pos_limit=100)
    want = occ.sort_occurrences_plain(pos, ids, id_bits=20, pos_limit=100)
    assert int(got[1]) == int(want[1]) == 4


def _dist_inputs(seed=14, length=6000):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.03, 0.1) for _ in range(3)]
    return [(i, dna.encode(s)) for i, s in enumerate(seqs)]


def test_sharded_sort_step_kernels(dev):
    """The distributed step on 4 shards of one card: kernels and plain
    versions give the same blocks and counts."""
    k, P, B = 25, 256, 8
    mesh = LocalMesh([dev] * 4)
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    # two rows of each genome's start, so junctions form inside the batch
    seqs = [(i, c[: 2 * P]) for i, c in _dist_inputs()]
    b = next(windows.iter_window_batches(iter(seqs), cfg.window_config()))
    assert len(set(b.seq_id.tolist())) == 4
    p, m = pack.pack_codes_host(b.codes)
    parts = [mesh.put_rows(a) for a in (p, m, b.valid)]
    batch = {s: tuple(x[s] for x in parts) for s in mesh.shards}
    scfg = sortshard.SortShardConfig(base=PassConfig(k=k, positions_per_row=P,
                                                     rows_per_batch=B), n_shards=4)
    build.reset_launch_counts()
    got = sortshard.sharded_sort_step(mesh, scfg)(batch, 0, 0xFFFFFFFF, NO_AB)
    assert build.launch_counts() == {"build_records": 4, "route": 4, "sort_records": 4,
                                     "judge_records": 4}
    want = sortshard.sharded_sort_step(mesh, scfg, ops=versions.PLAIN)(
        batch, 0, 0xFFFFFFFF, NO_AB)
    assert got[1:] == want[1:] and got[1] > 0 and got[3] == 0
    for s in mesh.shards:
        for a, b_ in zip(got[0][s], want[0][s]):
            assert _equal(a, b_)


@pytest.mark.parametrize("rounds", [1, 2])
def test_dist_engine_cuda_equals_plain(dev, tmp_path, rounds):
    """build_junctions_dist on a LocalMesh of 4 shards of one card: the
    kernels' .dbg equals the plain run's and the sort engine's; the
    shards' entries merge on the card and emit.cu writes the merged keys."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, rounds=rounds, positions_per_row=256, rows_per_batch=8)
    outs = []
    for reference in (False, True):
        out = str(tmp_path / f"{reference}.dbg")
        build.reset_launch_counts()
        distpipe.build_junctions_dist(None, cfg, LocalMesh([dev] * 4), out,
                                      sequences=sequences, device=dev, reference=reference)
        outs.append(open(out, "rb").read())
        counts = build.launch_counts()
        if reference:
            assert counts == {}
        else:
            want = {"upload_rows", "word0_histogram", "build_records", "route", "compact",
                    "sort_records", "judge_compact", "sort_occurrences", "merge_rows",
                    "merge_keys", "emit_check", "emit_chunk"} | (
                        {"histogram"} if rounds > 1 else set())
            assert set(counts) == want, counts
    sort_out = str(tmp_path / "sort.dbg")
    build_junctions_sorted(None, cfg, sort_out, sequences=sequences, device="cuda")
    assert outs[0] == outs[1] == open(sort_out, "rb").read() and len(outs[0]) > 0


@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("bloom_gate", [False, True])
def test_dist_engines_cut_key_bits_cuda(dev, tmp_path, k, bloom_gate):
    """dist and dist-bloom at k = 25 (the u64 key cut to 50 bits) and 33
    (the last word cut to 2), -r 2 over 4 shards of the card: the kernels'
    .dbg equals the plain run's and the sort engine's."""
    sequences = _dist_inputs(seed=k)
    gate = dict(filter_bits=20, layout="bit") if bloom_gate else {}
    cfg = PipelineConfig(k=k, rounds=2, positions_per_row=256, rows_per_batch=8, **gate)
    outs = []
    for reference in (False, True):
        out = str(tmp_path / f"{reference}.dbg")
        distpipe.build_junctions_dist(None, cfg, LocalMesh([dev] * 4), out, sequences=sequences,
                                      device=dev, reference=reference, bloom_gate=bloom_gate)
        outs.append(open(out, "rb").read())
    sort_out = str(tmp_path / "sort.dbg")
    build_junctions_sorted(None, cfg, sort_out, sequences=sequences, device="cuda")
    assert outs[0] == outs[1] == open(sort_out, "rb").read() and len(outs[0]) > 0


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _partitions_equal(a, b):
    """The same (chr, pos) occurrences, and the same partition of them into
    junction classes, as scripts/check_parity.py partitions_equal (which
    imports the JAX package): ids are never compared raw, a sign is a
    strand."""
    (ca, pa, ia), (cb, pb, ib) = a, b
    if len(ia) != len(ib):
        return False
    oa, ob = np.lexsort((pa, ca)), np.lexsort((pb, cb))
    if not (np.array_equal(ca[oa], cb[ob]) and np.array_equal(pa[oa], pb[ob])):
        return False
    ia, ib = np.abs(ia[oa]), np.abs(ib[ob])
    pairs = (ia.astype(np.uint64) << np.uint64(32)) | ib.astype(np.uint64)
    return len(np.unique(pairs)) == len(np.unique(ia)) == len(np.unique(ib))


@pytest.mark.parametrize("k", [129, 603])
@pytest.mark.parametrize("engine", ["sort", "bloom", "dist", "dist-bloom"])
def test_large_k_engines_cuda(dev, tmp_path, k, engine):
    """Every engine on the card at k = 129 and 603 on largek.fa: the
    reference binary's junction positions and partition."""
    cfg = PipelineConfig(k=k, filter_bits=16, engine=engine, positions_per_row=256,
                         rows_per_batch=8)
    out = str(tmp_path / "port.dbg")
    fa = os.path.join(GOLDEN, "largek.fa")
    build.reset_launch_counts()
    if engine.startswith("dist"):
        distpipe.build_junctions_dist([fa], cfg, LocalMesh([dev] * 4), out, device=dev,
                                      bloom_gate=engine == "dist-bloom")
    else:
        build_junctions([fa], cfg, out, device="cuda")
    assert build.launch_counts().get("sort_records", 0) > 0
    assert _partitions_equal(junctions.read_junctions(out),
                             junctions.read_junctions(os.path.join(GOLDEN, f"largek_k{k}.dbg")))


# ---- the dist-bloom engine: bloom_shard.cu's four entries, the gated
# record build, and the engine on a 4-shard LocalMesh


def _shard_cfg(k, f, layout, q, P, B, D):
    return sharded.ShardedConfig(
        base=PassConfig(k=k, q=q, f=f, layout=layout, positions_per_row=P, rows_per_batch=B),
        n_shards=D)


@pytest.mark.parametrize("D,layout,f", [
    (1, "byte", 20), (3, "byte", 20), (4, "bit", 22), (8, "bit", 20), (4, "bit", 36),
    (3, "bit", 33), (8, "byte", 40), (11, "byte", 20), (20, "bit", 36), (9, "byte", 20),
    (300, "bit", 36), (300, "byte", 20), (4, "bit", 32),
])
@pytest.mark.parametrize("mode", ["fill", "mark"])
@pytest.mark.parametrize("tiny", [False, True])
def test_shard_bucket_kernel(dev, D, layout, f, mode, tiny):
    """Send slots, probe slots and the overflow count equal the plain
    version's exactly (32- and 64-bit indices, f = 32 the first that
    travels as u64; up to 300 owners in shared-memory counters; a
    tiny cap overflows inside the first tile). test_shard_bucket_kernel_tiles
    adds many tiles, gates, empty rows and caps crossed mid-tile."""
    k, P, B, q = 25, 512, 8, 3
    rng = np.random.default_rng(D * 100 + f)
    args = _to(dev, *_genome_batch(rng, B, P, k))
    scfg = _shard_cfg(k, f, layout, q, P, B * D, D)
    cap = min(64, 2048 // D) if tiny else (scfg.fill_cap if mode == "fill" else scfg.mark_cap)
    want = _bucket_equal(args, scfg, cap, mode)
    assert (int(want[-1]) > 7) == tiny
    assert bool((want[0] != shardbloom.SENT).any())


def _bucket_equal(args, scfg, cap, mode, low=0, high=0xFFFFFFFF):
    """One launch of the bucket kernel; its send slots, probe slots and
    overflow (added to 7) equal the plain version's. -> the plain's."""
    fn = shardbloom.bucket_fill if mode == "fill" else shardbloom.bucket_mark
    plain = shardbloom.bucket_fill_plain if mode == "fill" else shardbloom.bucket_mark_plain
    D = scfg.n_shards
    over = torch.full((1,), 7, dtype=torch.int64, device=args[0].device)
    build.reset_launch_counts()
    got = fn(*args, low, high, cfg=scfg.base, n_shards=D, cap=cap, overflow=over.clone())
    assert build.launch_counts() == {f"shard_bucket_{mode}": 1}
    want = plain(*args, low, high, cfg=scfg.base, n_shards=D, cap=cap, overflow=over.clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


@pytest.mark.parametrize("D", [1, 4, 9, 300, 4096])
@pytest.mark.parametrize("f", [24, 32, 36])
def test_shard_scratch_bytes_match_the_kernel(dev, D, f):
    """passes/shardbloom.py scratch_bytes mirrors tp_shard_scratch_bytes
    (the tile plan included); the kernel has no plan (0) exactly where
    tile_fits says no, and there the wrapper refuses."""
    lib = build.lib()
    for q in (1, 3, 5, 16, 64, 2000):
        for mark in (0, 1):
            fits = shardbloom.tile_fits(D, q, f, bool(mark))
            for n in (0, 1, 255, 256, 131072):
                got = lib.tp_shard_scratch_bytes(n, D, q, f, mark)
                assert (got != 0) == fits
                if fits:
                    assert got == shardbloom.scratch_bytes(n, D, q, f, bool(mark))
    if D == 4 and f == 36:
        assert not shardbloom.tile_fits(D, 2000, f, True)
        scfg = _shard_cfg(25, f, "bit", 2000, 64, 4 * D, D)
        args = _to(dev, *_genome_batch(np.random.default_rng(0), 4, 64, 25))
        with pytest.raises(ValueError, match="shared memory"):
            shardbloom.bucket_mark(*args, 0, 0xFFFFFFFF, cfg=scfg.base, n_shards=D, cap=64)


@pytest.mark.parametrize("D", [4, 33])
def test_lookback_scratch_shared(dev, D):
    """The route and both bucket modes take turns on one kept look-back
    scratch of the stream, the first bucketing overflowing: each call
    equals its plain version (epoch-tagged status words, the tail kernels
    resetting the tile counter), and no call that fits the scratch
    reallocates it."""
    rng = np.random.default_rng(D + 5)
    k, P, B = 25, 512, 8
    args = _to(dev, *_genome_batch(rng, B, P, k))
    scfg = _shard_cfg(k, 30, "byte", 3, P, B * D, D)
    scratch, _epoch = build.lookback_scratch(args[0].device, 1 << 20)
    for i, (mode, cap) in enumerate((("fill", 64), ("mark", scfg.mark_cap),
                                     ("fill", scfg.fill_cap))):
        assert (int(_bucket_equal(args, scfg, cap, mode)[-1]) > 7) == (i == 0)
        recs = _to(dev, *_random_records(rng, 20_000 // (i + 1), 2))
        got = route.route_records(*recs, D, 4_000)
        want = route.route_records_plain(*recs, D, 4_000)
        for a, b in zip(got, want):
            assert _equal(a, b)
    assert build.lookback_scratch(args[0].device, 8)[0] is scratch


# D, layout, f, q, rows a shard, P, round gate, valid counts, cap
BUCKET_TILE_CASES = {
    "512_tiles": (4, "byte", 30, 5, 64, 2048, "full", "genome", "path"),
    "narrow_gate": (4, "byte", 24, 3, 16, 1024, "narrow", "genome", "path"),
    "empty_rows": (4, "bit", 22, 3, 16, 512, "full", "zero_short", "path"),
    "D9": (9, "byte", 24, 3, 16, 512, "full", "genome", "path"),
    "D300": (300, "byte", 20, 3, 8, 512, "narrow", "zero_short", "path"),
    "D300_64bit": (300, "bit", 36, 2, 8, 512, "full", "genome", "path"),
    "cap_mid_tile": (4, "byte", 30, 5, 16, 2048, "full", "genome", "half"),
    "cap_mid_tile_64bit": (3, "bit", 36, 3, 16, 1024, "narrow", "zero_short", "half"),
    "q64_64bit": (4, "bit", 36, 64, 4, 512, "full", "genome", "path"),
    "q1000_one_position": (4, "bit", 36, 1000, 2, 64, "narrow", "zero_short", "path"),
}


@pytest.mark.parametrize("case", list(BUCKET_TILE_CASES))
@pytest.mark.parametrize("mode", ["fill", "mark"])
def test_shard_bucket_kernel_tiles(dev, case, mode):
    """The one-sweep bucketing across tiles: a batch of 512 tiles (the
    look-back over tiles that finish out of order), a narrow round gate,
    rows with valid 0 and short valid counts (empty and partial tiles),
    D = 9 and 300 owners, a cap that an owner's run crosses inside a
    tile, and large q (tiles of 8 positions at q = 64, of one at q =
    1000): everything equals the plain version's."""
    D, layout, f, q, B, P, gate, valid, cap_kind = BUCKET_TILE_CASES[case]
    k = 25
    rng = np.random.default_rng(len(case) * 31 + f)
    p, m, v = _genome_batch(rng, B, P, k)
    if valid == "zero_short":
        v[::3] = 0
        v[1::3] = 37
    args = _to(dev, p, m, v)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    scfg = _shard_cfg(k, f, layout, q, P, B * D, D)
    cap = scfg.fill_cap if mode == "fill" else scfg.mark_cap
    tpos = shardbloom.tile_positions(D, q, f, mode == "mark")
    if case == "512_tiles":
        assert -(-B * P // tpos) >= 512
    if case.startswith("q"):
        assert tpos == ({"fill": 16, "mark": 8} if q == 64 else {"fill": 1, "mark": 1})[mode]
    if cap_kind == "half":
        send = shardbloom.bucket_fill_plain if mode == "fill" else shardbloom.bucket_mark_plain
        per_owner = (send(*args, low, high, cfg=scfg.base, n_shards=D, cap=cap)[0]
                     != shardbloom.SENT).sum(dim=1)
        cap = int(per_owner[1]) // 2 + 5
    want = _bucket_equal(args, scfg, cap, mode, low, high)
    assert (int(want[-1]) > 7) == (cap_kind == "half")
    assert bool((want[0] != shardbloom.SENT).any())


@pytest.mark.parametrize("D,layout,f", [
    (1, "byte", 20), (3, "byte", 21), (4, "bit", 20), (8, "bit", 24), (4, "bit", 34),
    (3, "bit", 33),
])
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_sharded_fill_mark_kernels(dev, D, layout, f, gate):
    """sharded_fill_step and sharded_mark_step over D shards of the card:
    every filter shard, mask, count and overflow equals the plain run's."""
    k, P, q = 25, 256, 3
    B = 2 * D
    rng = np.random.default_rng(f + D)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    scfg = _shard_cfg(k, f, layout, q, P, B, D)
    mesh = LocalMesh([dev] * D)
    batches = []
    for _ in range(3):
        parts = [mesh.put_rows(a) for a in _genome_batch(rng, B, P, k)]
        batches.append({s: tuple(x[s] for x in parts) for s in mesh.shards})
    runs = []
    for ops in (versions.KERNELS, versions.PLAIN):
        filt = sharded.make_sharded_filter(mesh, scfg)
        fill_step = sharded.sharded_fill_step(mesh, scfg, ops)
        mark_step = sharded.sharded_mark_step(mesh, scfg, ops)
        build.reset_launch_counts()
        over = None
        for b in batches:
            over = fill_step(filt, b, low, high, over)
        marked = [mark_step(filt, b, low, high) for b in batches]
        counts = build.launch_counts()
        if ops is versions.KERNELS:
            n = 3 * D
            assert counts == {"shard_bucket_fill": n, "shard_bucket_mark": n, "shard_fill": n,
                              "shard_probe": n, "shard_mark_finish": n}
        else:
            assert counts == {}
        runs.append((filt, over, marked))
    (fk, ok, mk), (fp, op, mp) = runs
    for s in mesh.shards:
        assert _filters_equal(fk[s], fp[s])
        assert int(ok[s]) == int(op[s]) == 0
    assert any(bool(fk[s].view(torch.uint8).any()) for s in mesh.shards)
    for (masks_k, count_k, over_k), (masks_p, count_p, over_p) in zip(mk, mp):
        for s in mesh.shards:
            assert torch.equal(masks_k[s], masks_p[s])
            assert int(count_k[s]) == int(count_p[s])
            assert int(over_k[s]) == int(over_p[s]) == 0
    assert sum(int(c[s]) for _m, c, _o in mk for s in mesh.shards) > 0


FILL_CHUNK = 4096  # received slots a block of the fill kernel


@pytest.mark.parametrize("D,layout,f", [(1, "byte", 22), (3, "byte", 22), (4, "bit", 24),
                                        (20, "bit", 36), (20, "byte", 24)])
@pytest.mark.parametrize("cap,aligned", [(3 * FILL_CHUNK + 6, True), (3 * FILL_CHUNK + 5, True),
                                         (2 * FILL_CHUNK, False)])
def test_fill_local_prefix_rows(dev, D, layout, f, cap, aligned):
    """Hand-made received blocks, each row a prefix of sent slots then
    SENT: empty rows, full rows (count == cap), counts at a chunk boundary
    and one either side; even caps (16-byte loads), odd caps and a block
    starting 8 bytes off 16 (8-byte loads). f = 36 over 20 shards: local
    slots past 2^32. The filter equals the plain version's."""
    scfg = _shard_cfg(25, f, layout, 2, 256, 8 * D, D)
    rng = np.random.default_rng(D * 7 + cap)
    counts = [0, cap, FILL_CHUNK - 1, FILL_CHUNK, FILL_CHUNK + 1, 2 * FILL_CHUNK,
              int(rng.integers(0, cap + 1))]
    recv_np = np.full((D, cap), -1, np.int64)
    for d in range(D):
        c = min(counts[(d + 1) % len(counts)], cap)
        recv_np[d, :c] = rng.integers(0, scfg.local_slots, size=c)
    flat = torch.full((D * cap + 1,), -1, dtype=torch.int64, device=dev)
    recv = flat[0 if aligned else 1:][: D * cap].view(D, cap)
    recv.copy_(torch.from_numpy(recv_np))
    fk = bloom.make_filter(f, layout, dev, slots=scfg.local_slots)
    fp = bloom.make_filter(f, layout, dev, slots=scfg.local_slots)
    build.reset_launch_counts()
    shardbloom.fill_local(fk, recv, layout)
    assert build.launch_counts() == {"shard_fill": 1}
    shardbloom.fill_local_plain(fp, recv, layout)
    assert _filters_equal(fk, fp) and bool(fp.view(torch.uint8).any())
    with pytest.raises(ValueError, match="block"):
        shardbloom.fill_local(fk, recv.reshape(-1), layout)


PROBE_CHUNK = 4096  # received slots a block of the probe kernel


@pytest.mark.parametrize("D,layout,f", [(1, "byte", 22), (3, "byte", 22), (4, "bit", 24),
                                        (20, "bit", 36), (20, "byte", 24)])
@pytest.mark.parametrize("cap,aligned", [(3 * PROBE_CHUNK + 16, True),
                                         (3 * PROBE_CHUNK + 5, True),
                                         (3 * PROBE_CHUNK + 6, True), (2 * PROBE_CHUNK, False)])
def test_probe_local_prefix_rows(dev, D, layout, f, cap, aligned):
    """Hand-made received blocks, each row a prefix of sent slots then
    SENT: empty rows, full rows (count == cap), counts at a chunk boundary
    and one either side; caps of 0, 1 and 2 mod 4 (rows and hits starting
    off their alignment), and a block starting 8 bytes off 16. f = 36 over
    20 shards: local slots past 2^32. The hits equal the plain version's
    everywhere, zeros past each prefix."""
    scfg = _shard_cfg(25, f, layout, 2, 256, 8 * D, D)
    rng = np.random.default_rng(D * 7 + cap)
    counts = [0, cap, PROBE_CHUNK - 1, PROBE_CHUNK, PROBE_CHUNK + 1, 2 * PROBE_CHUNK,
              int(rng.integers(0, cap + 1))]
    recv_np = np.full((D, cap), -1, np.int64)
    for d in range(D):
        c = min(counts[(d + 1) % len(counts)], cap)
        recv_np[d, :c] = rng.integers(0, scfg.local_slots, size=c)
    flat = torch.full((D * cap + 1,), -1, dtype=torch.int64, device=dev)
    recv = flat[0 if aligned else 1:][: D * cap].view(D, cap)
    recv.copy_(torch.from_numpy(recv_np))
    filt = bloom.make_filter(f, layout, dev, slots=scfg.local_slots)
    gen = torch.Generator(device=dev).manual_seed(D + cap)
    fb = filt.view(torch.uint8)
    fb.copy_(torch.randint(0, 256 if layout == "bit" else 2, fb.shape, generator=gen,
                           device=dev, dtype=torch.uint8))
    build.reset_launch_counts()
    got = shardbloom.probe_local(filt, recv, layout)
    assert build.launch_counts() == {"shard_probe": 1}
    want = shardbloom.probe_local_plain(filt, recv, layout)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int((recv != shardbloom.SENT).sum())
    with pytest.raises(ValueError, match="block"):
        shardbloom.probe_local(filt, recv.reshape(-1), layout)


@pytest.mark.parametrize("D,layout,f", [(1, "byte", 20), (3, "byte", 21), (4, "bit", 22),
                                        (20, "bit", 36)])
def test_fill_local_bucketed_rows(dev, D, layout, f):
    """The rows tp_shard_bucket writes, every shard's sends exchanged: the
    filter equals the plain version's."""
    k, P, q = 25, 512, 3
    rng = np.random.default_rng(D + f)
    scfg = _shard_cfg(k, f, layout, q, P, 4 * D, D)
    mesh = LocalMesh([dev] * D)
    parts = [mesh.put_rows(a) for a in _genome_batch(rng, 4 * D, P, k)]
    sends = {s: (shardbloom.bucket_fill(*(x[s] for x in parts), 0, 0xFFFFFFFF, cfg=scfg.base,
                                        n_shards=D, cap=scfg.fill_cap)[0],)
             for s in mesh.shards}
    recv = mesh.all_to_all(sends)[D - 1][0].view(D, scfg.fill_cap)
    fk = bloom.make_filter(f, layout, dev, slots=scfg.local_slots)
    fp = bloom.make_filter(f, layout, dev, slots=scfg.local_slots)
    shardbloom.fill_local(fk, recv, layout)
    shardbloom.fill_local_plain(fp, recv, layout)
    assert _filters_equal(fk, fp) and bool(fp.view(torch.uint8).any())


@pytest.mark.parametrize("q", [1, 3, 5])
@pytest.mark.parametrize("k", [25, 33])
def test_shard_probe_and_mark_finish_unsent_probes(dev, q, k):
    """Probes past a tiny cap are not sent and read as misses, in the
    kernels as in the plain versions (the counts may then differ from a
    full cap's, and the engine raises on the overflow)."""
    P, D = 256, 4
    rng = np.random.default_rng(3 + q + k)
    args = _to(dev, *_genome_batch(rng, 8, P, k))
    scfg = _shard_cfg(k, 20, "byte", q, P, 8 * D, D)
    filt = bloom.make_filter(20, "byte", dev, slots=scfg.local_slots)
    filt[::3] = 1
    outs = []
    for bucket, probe, finish in (
        (shardbloom.bucket_mark, shardbloom.probe_local, shardbloom.mark_finish),
        (shardbloom.bucket_mark_plain, shardbloom.probe_local_plain,
         shardbloom.mark_finish_plain),
    ):
        send, slots, over = bucket(*args, 0, 0xFFFFFFFF, cfg=scfg.base, n_shards=D, cap=500)
        hits = probe(filt, send, "byte")  # one shard receiving its own sends
        outs.append((send, slots, over, hits, *finish(hits, slots, *args, 0, 0xFFFFFFFF,
                                                         cfg=scfg.base)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[1][2]) > 0 and int(outs[1][5]) > 0


@pytest.mark.parametrize("run", [8, 4, 2, 1])
@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("gate", ["full", "narrow"])
def test_shard_mark_finish_runs(dev, run, q, k, gate):
    """The mark finish where a thread rolls along runs of 8, 4, 2 and 1
    positions: a batch sized so that the card's grid takes that run (1.5
    times the rows whose threads would give every SM 1024 at it), with N
    runs, short and zero valid counts, and random probe slots (a tenth not
    sent) into a block of hits of which most are set: the mask and count
    equal the plain version's, in one launch."""
    P = 512
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    R = int(1.5 * 1024 * sms * run / P)
    assert build.lib().tp_bloom_run(R * P, 1) == run
    rng = np.random.default_rng(run * 1000 + q * 10 + k + len(gate))
    args = _to(dev, *_n_run_batch(rng, R, P, k))
    cfg = PassConfig(k=k, q=q, f=20, layout="byte", positions_per_row=P, rows_per_batch=R)
    gen = torch.Generator(device=dev).manual_seed(run + q + k)
    S = 1 << 20
    slots = torch.randint(0, S, (8 * q, R * P), generator=gen, device=dev, dtype=torch.int32)
    slots[torch.rand(slots.shape, generator=gen, device=dev) < 0.1] = -1
    back = (torch.rand(S, generator=gen, device=dev) < 0.85).to(torch.uint8)
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    build.reset_launch_counts()
    mk, ck = shardbloom.mark_finish(back, slots, *args, low, high, cfg=cfg)
    assert build.launch_counts() == {"shard_mark_finish": 1}
    mp, cp = shardbloom.mark_finish_plain(back, slots, *args, low, high, cfg=cfg)
    assert torch.equal(mk, mp) and torch.equal(ck, cp) and 0 < int(cp) < R * P


@pytest.mark.parametrize("k", [11, 25, 101])
def test_build_records_gated_kernel(dev, k):
    """The candidate mask gate: records of positions whose bit is 0 become
    sentinels with payload 0, as the plain version's; no mask is the
    ungated build."""
    rng = np.random.default_rng(k + 1)
    B, P = 16, 512
    args = _to(dev, *_genome_batch(rng, B, P, k))
    mask = torch.from_numpy(rng.integers(0, 256, size=(B, P // 8)).astype(np.uint8)).to(dev)
    build.reset_launch_counts()
    got = records.build_sort_records(*args, 77, k=k, P=P, low=1 << 29, high=3 << 30, mask=mask)
    assert build.launch_counts() == {"build_records": 1}
    want = records.build_sort_records_plain(*args, 77, k=k, P=P, low=1 << 29, high=3 << 30,
                                            mask=mask)
    for a, b in zip(got, want):
        assert _equal(a, b)
    ungated = records.build_sort_records(*args, 77, k=k, P=P, low=1 << 29, high=3 << 30)
    real = pack.as_i64(got[1]) >> 17 & 1
    assert 0 < int(real.sum()) < int((pack.as_i64(ungated[1]) >> 17 & 1).sum())


def test_shard_wrappers_never_reach_the_plain_code(dev, monkeypatch):
    """CUDA tensors given to the dist-bloom wrappers launch their kernels:
    the plain versions, made to raise here, are never called."""
    def boom(*a, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("bucket_fill_plain", "bucket_mark_plain", "fill_local_plain",
                 "probe_local_plain", "mark_finish_plain"):
        monkeypatch.setattr(shardbloom, name, boom)
    monkeypatch.setattr(records, "build_sort_records_plain", boom)
    k, P, D = 25, 256, 4
    rng = np.random.default_rng(9)
    args = _to(dev, *_genome_batch(rng, 8, P, k))
    scfg = _shard_cfg(k, 20, "bit", 3, P, 8 * D, D)
    filt = bloom.make_filter(20, "bit", dev, slots=scfg.local_slots)
    build.reset_launch_counts()
    send, _over = shardbloom.bucket_fill(*args, 0, 0xFFFFFFFF, cfg=scfg.base, n_shards=D,
                                         cap=scfg.fill_cap)
    shardbloom.fill_local(filt, send, "bit")
    send, slots, _over = shardbloom.bucket_mark(*args, 0, 0xFFFFFFFF, cfg=scfg.base,
                                                n_shards=D, cap=scfg.mark_cap)
    hits = shardbloom.probe_local(filt, send, "bit")
    mask, _count = shardbloom.mark_finish(hits, slots, *args, 0, 0xFFFFFFFF, cfg=scfg.base)
    records.build_sort_records(*args, 0, k=k, P=P, mask=mask)
    assert build.launch_counts() == {"shard_bucket_fill": 1, "shard_bucket_mark": 1,
                                     "shard_fill": 1, "shard_probe": 1,
                                     "shard_mark_finish": 1, "build_records": 1}


@pytest.mark.parametrize("rounds,layout", [(1, "byte"), (2, "bit")])
def test_dist_bloom_engine_cuda_equals_plain(dev, tmp_path, rounds, layout):
    """build_junctions_dist(bloom_gate=True) on a LocalMesh of 4 shards of
    one card: the kernels' .dbg equals the plain run's and the sort
    engine's; the shards' entries merge on the card and emit.cu writes the
    merged keys."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, rounds=rounds, filter_bits=22, layout=layout,
                         positions_per_row=256, rows_per_batch=8)
    outs = []
    for reference in (False, True):
        out = str(tmp_path / f"{reference}.dbg")
        build.reset_launch_counts()
        distpipe.build_junctions_dist(None, cfg, LocalMesh([dev] * 4), out, sequences=sequences,
                                      device=dev, reference=reference, bloom_gate=True)
        outs.append(open(out, "rb").read())
        counts = build.launch_counts()
        if reference:
            assert counts == {}
        else:
            want = {"upload_rows", "word0_histogram", "shard_bucket_fill", "shard_bucket_mark",
                    "shard_fill", "shard_probe", "shard_mark_finish", "build_records", "route",
                    "compact", "sort_records", "judge_compact", "sort_occurrences", "merge_rows",
                    "merge_keys", "emit_check", "emit_chunk"} | (
                        {"histogram"} if rounds > 1 else set())
            assert set(counts) == want, counts
    sort_out = str(tmp_path / "sort.dbg")
    build_junctions_sorted(None, cfg, sort_out, sequences=sequences, device="cuda")
    assert outs[0] == outs[1] == open(sort_out, "rb").read() and len(outs[0]) > 0


# ---- the record build's table entry and the three-launch judge


def _n_run_batch(rng, B, P, k, n_runs=6):
    """(packed, nmask, valid) numpy of B genome rows with runs of N (1 to
    k + 3 chars) and their own valid counts (row 0 full, row 1 empty)."""
    R = P + k + 1
    base = rng.integers(0, 4, size=2 * R).astype(np.uint8)
    codes = np.stack([base[s : s + R] for s in rng.integers(0, R, size=B)])
    flip = rng.random(codes.shape) < 0.02
    codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
    for r in range(B):
        for _ in range(n_runs):
            s = int(rng.integers(0, R))
            codes[r, s : s + int(rng.integers(1, k + 4))] = 4
    valid = rng.integers(0, P + 1, size=B).astype(np.int32)
    valid[0], valid[min(1, B - 1)] = P, 0
    p, m = pack.pack_codes_host(codes)
    return p, m, valid


def _mask(dev, rng, B, P):
    return torch.from_numpy(rng.integers(0, 256, size=(B, P // 8)).astype(np.uint8)).to(dev)


@pytest.mark.parametrize("k", [11, 25, 33, 101, 129, 603])
@pytest.mark.parametrize("gate", ["full", "narrow", "mask"])
def test_build_records_batches_kernel(dev, k, gate):
    """One launch over a table of batches of different row and valid
    counts with N runs, at their bases (a gap between two): equal to the
    per-batch plain version in each batch's span, rows outside every span
    untouched."""
    rng = np.random.default_rng(k * 3 + len(gate))
    P = 512
    rows = [16, 8, 16, 3, 1]
    uploads = [_to(dev, *_n_run_batch(rng, r, P, k, n_runs=6 if k <= 101 else 1)) for r in rows]
    bases, off = [], 0
    for b, r in enumerate(rows):
        off += P * 5 if b == 2 else 0  # a gap before batch 2
        bases.append(off)
        off += r * P
    low, high = (1 << 29, 3 << 30) if gate == "narrow" else (0, 0xFFFFFFFF)
    masks = [_mask(dev, rng, r, P) for r in rows] if gate == "mask" else None
    w = -(-k // 16)
    out = (torch.full((off, w), 7, dtype=torch.int32, device=dev).view(torch.uint32),
           torch.full((off,), 7, dtype=torch.int32, device=dev).view(torch.uint32),
           torch.full((off,), 7, dtype=torch.int64, device=dev))
    want = tuple(t.clone() for t in out)
    build.reset_launch_counts()
    got = records.build_sort_records_batches(uploads, bases, k=k, P=P, low=low, high=high,
                                             out=out, masks=masks)
    assert build.launch_counts() == {"build_records": 1} and got is out
    records.build_sort_records_batches_plain(uploads, bases, k=k, P=P, low=low, high=high,
                                             out=want, masks=masks)
    for a, b in zip(got, want):
        assert _equal(a, b)
    assert int((pack.as_i64(got[1]) >> 17 & 1).sum()) > 0
    assert int((got[2][bases[2] - 1] == 7)) == 1  # the gap is untouched


@pytest.mark.parametrize("k", [11, 25, 33, 64, 65, 101, 129, 603])
@pytest.mark.parametrize("rows", [1, 64, 256])
def test_build_records_one_batch_kernel(dev, k, rows):
    """The one-batch form (no table) at a dist append's shapes and at one
    row, with the narrow gate and a candidate mask, equal to the plain
    version."""
    rng = np.random.default_rng(k + rows)
    P = 2048
    args = _to(dev, *_n_run_batch(rng, rows, P, k, n_runs=6 if k <= 101 else 1))
    mask = _mask(dev, rng, rows, P)
    build.reset_launch_counts()
    got = records.build_sort_records(*args, 999, k=k, P=P, low=1 << 29, high=3 << 30, mask=mask)
    assert build.launch_counts() == {"build_records": 1}
    want = records.build_sort_records_plain(*args, 999, k=k, P=P, low=1 << 29, high=3 << 30,
                                            mask=mask)
    for a, b in zip(got, want):
        assert _equal(a, b)


def test_sort_engine_builds_a_round_in_one_launch(dev, tmp_path):
    """-r 1 of the sort engine: one build_records launch for the round's
    batches, the plain run's bytes."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, positions_per_row=256, rows_per_batch=8)
    outs = []
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.dbg")
        build.reset_launch_counts()
        build_junctions_sorted(None, cfg, out, sequences=sequences, device=device)
        outs.append(open(out, "rb").read())
        if device == "cuda":
            assert build.launch_counts()["build_records"] == 1
    assert outs[0] == outs[1] and len(outs[0]) > 0


_JUDGE_CASES: dict = {}


def _judge_case(dev, name):
    if name not in _JUDGE_CASES:
        _JUDGE_CASES.clear()  # one case held at a time (over_2_24 is 200 MB)
        words, pay, pos = judge_cases.make(name, seed=len(name))
        _JUDGE_CASES[name] = (pack.as_u32(torch.from_numpy(words.astype(np.int64)).to(dev)),
                              pack.as_u32(torch.from_numpy(pay.astype(np.int64)).to(dev)),
                              torch.from_numpy(pos).to(dev))
    return _JUDGE_CASES[name]


def _judge_both(entry, case, abundance, stats=None, want_stats=None):
    """Both versions of one judge entry; the compact entry's real records
    and largest group into the dicts given."""
    sw, spay, spos = case
    if entry == "compact":
        return (judge.judge_compact(sw, spay, spos, abundance, stats),
                judge.judge_compact_plain(sw, spay, spos, abundance, want_stats))
    return judge.judge_records(sw, spay, abundance), judge.judge_records_plain(sw, spay, abundance)


@pytest.mark.parametrize("name", sorted(judge_cases.CASES))
@pytest.mark.parametrize("abundance", [NO_AB, 3])
@pytest.mark.parametrize("entry", ["compact", "records"])
def test_judge_edge_cases_kernel(dev, name, abundance, entry):
    """Both judge entries on the edge inputs (a group over many tiles with
    saturated N-in counts, tile-edge groups, one record, counts off the
    tile, over 2^24 records, all and mostly sentinels, a repeat-bearing
    round): equal to the plain versions, the compact entry's real records
    and largest group too, one launch counted."""
    build.reset_launch_counts()
    stats, want_stats = {}, {}
    got, want = _judge_both(entry, _judge_case(dev, name), abundance, stats, want_stats)
    assert build.launch_counts() == {f"judge_{entry}": 1}
    assert got[3:] == want[3:]
    assert stats == want_stats
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)
    if name == "long_group" and abundance == NO_AB:
        assert got[4] > 0


def test_sort_and_judge_on_repeat_groups(dev):
    """sort.cu and judge.cu on a repeat-bearing round (judge_cases
    repeat_groups): a k-mer group of 8 judge tiles and more (several sort
    tiles of one key) starting and ending mid-tile, a group ending exactly
    on a tile boundary, both strands in the groups. The records, shuffled,
    are sorted by their 62 leading bits (k = 31) and judged; each output,
    the real records and the largest group equal the plain versions'."""
    words, pay, pos = judge_cases.make("repeat_groups", seed=23)
    starts = np.flatnonzero(np.r_[True, (words[1:] != words[:-1]).any(axis=1)])
    ends = np.r_[starts[1:], len(words)]
    big = int(np.argmax(ends - starts))
    assert ends[big] - starts[big] >= 8 * judge_cases.TILE
    assert starts[big] % judge_cases.TILE and ends[big] % judge_cases.TILE
    assert ends[big + 1] % judge_cases.TILE == 0
    strand = (pay >> 16) & 1
    assert set(strand[starts[big] : ends[big]]) == {0, 1}
    perm = np.random.default_rng(5).permutation(len(words))
    recs = (pack.as_u32(torch.from_numpy(words[perm].astype(np.int64)).to(dev)),
            pack.as_u32(torch.from_numpy(pay[perm].astype(np.int64)).to(dev)),
            torch.from_numpy(pos[perm]).to(dev))
    build.reset_launch_counts()
    srt = sort.sort_records(*recs, key_bits=62)
    assert build.launch_counts() == {"sort_records": 1}
    want_srt = sort.sort_records_plain(*recs, key_bits=62)
    for a, b in zip(srt, want_srt):
        assert _equal(a, b)
    assert np.array_equal(pack.as_i64(srt[0]).cpu().numpy(), words.astype(np.int64))
    for entry in ("compact", "records"):
        stats, want_stats = {}, {}
        got, want = _judge_both(entry, srt, NO_AB, stats, want_stats)
        assert got[3:] == want[3:] and got[4] > 0
        for a, b in zip(got[:3], want[:3]):
            assert _equal(a, b)
        if entry == "compact":
            assert stats == want_stats == {"records": int(np.count_nonzero(pay)),
                                           "group_max": int(ends[big] - starts[big])}


def test_judge_twice_and_after_route(dev):
    """Two judge calls in a row, then a route call and a judge on the
    same stream: each equal to the plain version."""
    rng = np.random.default_rng(5)
    cases = [_to(dev, *(a.astype(np.int64) if a.dtype == np.uint32 else a
                        for a in judge_cases.make(n, seed=s)))
             for n, s in (("off_tile", 1), ("long_group", 2), ("tile_edges", 3))]
    cases = [(pack.as_u32(w), pack.as_u32(p), pos) for w, p, pos in cases]
    recs = _to(dev, *_random_records(rng, 50_000, 2))
    for i, (sw, spay, spos) in enumerate(cases):
        if i == 2:
            route.route_records(*recs, 4, 20_000)
        for got, want in ((judge.judge_compact(sw, spay, spos), judge.judge_compact_plain(sw, spay, spos)),
                          (judge.judge_records(sw, spay, 3), judge.judge_records_plain(sw, spay, 3))):
            assert got[3:] == want[3:]
            for a, b in zip(got[:3], want[:3]):
                assert _equal(a, b)


def test_judge_scratch_is_small(dev, monkeypatch):
    """The judge allocates its outputs only, and its kept look-back
    scratch holds under a byte a record: no n-sized work buffer."""
    sw, spay, spos = _judge_case(dev, "off_tile")
    m = sw.shape[0]
    sizes = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        t = empty(*a, **kw)
        sizes.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    judge.judge_compact(sw, spay, spos)
    monkeypatch.undo()
    outputs = m * (4 * sw.shape[1] + 12) + 5 * 8  # the records' outputs, the five counts
    assert sum(sizes) == outputs
    assert build.lib().tp_judge_scratch_bytes(m) <= m


# ---- the native host path and serve mode on the card

def _golden_sha(name):
    with open(os.path.join(GOLDEN, "torch_port_sha256.json")) as f:
        return json.load(f)[name]["sha256"]


def _file_sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_serve_cuda_daemon_golden(dev, tmp_path):
    """A --device cuda daemon serves tests/golden/example.fa and writes
    the JAX-confirmed sha256; __shutdown__ stops it with exit 0."""
    root = os.path.dirname(GOLDEN)
    sock_dir = tempfile.mkdtemp(prefix="tps")
    sock = os.path.join(sock_dir, "cuda.sock")
    log = open(tmp_path / "server.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "twopaco_tpu_torch.cli.serve", "--device", "cuda",
         "--socket", sock], cwd=os.path.dirname(root), stdout=log, stderr=subprocess.STDOUT)
    log.close()

    def ask(tool, argv):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(300)
            s.connect(sock)
            req = json.dumps({"tool": tool, "argv": argv, "cwd": str(tmp_path)}).encode()
            s.sendall(struct.pack("<I", len(req)) + req)
            data = b""
            while True:
                chunk = s.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
        i, err = 0, b""
        while data[i:i + 1] != b"X":
            (n,) = struct.unpack("<I", data[i + 1:i + 5])
            err += data[i + 5:i + 5 + n] if data[i:i + 1] == b"E" else b""
            i += 5 + n
        return struct.unpack("<I", data[i + 1:i + 5])[0], err.decode()

    try:
        deadline = time.time() + 300
        while not os.path.exists(sock):
            assert proc.poll() is None and time.time() < deadline, open(
                tmp_path / "server.log").read()
            time.sleep(0.1)
        for _ in range(2):
            rc, err = ask("twopaco", ["-k", "11", "-f", "20", "-o", "o.dbg",
                                      os.path.join(GOLDEN, "example.fa")])
            assert rc == 0, err
            assert _file_sha(tmp_path / "o.dbg") == _golden_sha("example_k11")
        assert ask("__shutdown__", []) == (0, "")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)


@pytest.mark.parametrize("engine", ["sort", "bloom"])
def test_native_and_numpy_paths_same_dbg(dev, tmp_path, monkeypatch, engine):
    """The native encoder and emit and the numpy parser and writer give the
    same .dbg on the card (the JAX-confirmed sha256 of a two-file input)."""
    assert native.available(), native.status()
    paths = [bench_data.write_bench_fasta(str(tmp_path / "a.fa"), 3, 50000, 7),
             bench_data.write_bench_fasta(str(tmp_path / "b.fa"), 2, 40000, 11)]
    shas = []
    for on in ("1", "0"):
        monkeypatch.setenv("TWOPACO_NATIVE", on)
        out = str(tmp_path / f"o{on}.dbg")
        assert cli.main(["-k", "25", "-f", "20", "--tpu-engine", engine, *paths, "-o", out]) == 0
        shas.append(_file_sha(out))
    assert shas == [_golden_sha("bench_two_files_k25")] * 2


# ---- the upload (upload.cu) and the merge (merge.cu)


def _staged(rng, k, P, B, n=12):
    """(staged codes padded to 16 bytes, window_rows) of n sequences of
    awkward lengths with N runs, staged back to back at odd offsets."""
    lengths = [0, 3, k - 1, k, k + P - 1, k + P] + [
        int(x) for x in rng.integers(1, 5 * P + k, size=n)]
    codes = rng.integers(0, 4, size=sum(lengths)).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.02] = 4
    for i in rng.integers(0, max(len(codes) - 40, 1), size=8):
        codes[i : i + 33] = 4
    staged = np.zeros(-(-len(codes) // 16) * 16, np.uint8)
    staged[: len(codes)] = codes
    return staged, windows.window_rows(lengths, windows.WindowConfig(k, P, B))


@pytest.mark.parametrize("k,P,B", [(25, 2048, 256), (5, 16, 3), (101, 64, 4), (33, 100, 5),
                                   (63, 31, 7)])
def test_upload_kernel(dev, k, P, B):
    """upload.cu against its plain version, exact: rows at every offset
    mod 16 (aligned and unaligned loads), cut at sequence ends, pad rows,
    and a hand-made table (offsets before the codes, past them, clamped
    spans)."""
    rng = np.random.default_rng(k + P)
    staged, rows = _staged(rng, k, P, B)
    assert len({int(o) % 16 for o in rows.table[:, 0]}) >= 4  # unaligned rows
    extra = np.array([[-5, 0, 40], [len(staged) - 3, 0, len(staged)], [7, -9, 1 << 40],
                      [0, 0, 0], [-100, 0, 5]], np.int64)
    R = rows.row_chars
    for table in (rows.table, extra):
        codes_d, table_d = _to(dev, staged, np.ascontiguousarray(table))
        build.reset_launch_counts()
        got = upload.pack_rows(codes_d, table_d, R=R)
        assert build.launch_counts() == {"upload_rows": 1}
        want = upload.pack_rows_plain(codes_d, table_d, R=R)
        for a, b in zip(got, want):
            assert a.shape == b.shape and _equal(a, b)


def test_upload_kernel_refuses_unpadded_codes(dev):
    codes = torch.zeros(17, dtype=torch.uint8, device=dev)
    table = torch.zeros((1, 3), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        upload.pack_rows(codes, table, R=30)
    with pytest.raises(ValueError, match="aligned"):
        upload.pack_rows(torch.zeros(33, dtype=torch.uint8, device=dev)[1:17], table, R=30)


@pytest.mark.parametrize("D", [1, 4])
def test_upload_in_chunks_on_the_card(dev, D):
    """upload_batches under a staging budget of about two batches, a whole
    run's rows and each of D shards': one launch a chunk, the card's
    batches equal to the plain version's on the CPU, exact."""
    k, P, B = 25, 256, 8
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    _seqs, rows_all = sortpipe.read_batches(None, _dist_inputs(length=9000), cfg,
                                            sortpipe.RunStats())
    budget = 2 * (B * (P + k + 1) + 24 * B)
    for s in range(D):
        rows = slice(s * B // D, (s + 1) * B // D)
        r = len(range(B)[rows])
        idx = (np.arange(len(rows_all))[:, None] * B + np.arange(B)[rows]).reshape(-1)
        chunks, _least = upload.plan_chunks(rows_all.table[idx], rows_all.row_chars, r,
                                            rows_all.codes.numel(), budget)
        assert len(chunks) > 2
        build.reset_launch_counts()
        got = sortpipe.upload_batches(rows_all, dev, rows,
                                      stage_bytes=budget)
        assert build.launch_counts() == {"upload_rows": len(chunks)}
        want = sortpipe.upload_batches(rows_all, torch.device("cpu"), rows)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(_equal(a, b) for a, b in zip(g, w))


def test_serve_request_leaves_no_page_locked_memory(dev, tmp_path):
    """A request served on the card (serve._serve_one in this process)
    leaves PyTorch's page-locked host allocator as it found it: the staged
    input (4 MB) and the rounds' fetches are page-locked only for their
    copies (hostmem.pinned), never allocated or cached there."""
    import threading

    from twopaco_tpu_torch.cli import serve

    fa = bench_data.write_bench_fasta(str(tmp_path / "in.fa"), 2, 2_000_000, 5)

    def held():  # the allocator's blocks, in use or cached
        return {k: v for k, v in torch.cuda.host_memory_stats().items()
                if k.startswith("allocated_bytes") and k.endswith(".current")}

    def one_request():
        srv, cli_end = socket.socketpair()
        with srv, cli_end:
            req = json.dumps({"tool": "twopaco", "cwd": str(tmp_path), "argv": [
                "-k", "25", "-f", "20", "-r", "3", fa, "-o", "o.dbg"]}).encode()
            cli_end.sendall(struct.pack("<I", len(req)) + req)

            def serve_and_close():
                serve._serve_one(srv)
                srv.shutdown(socket.SHUT_WR)

            t = threading.Thread(target=serve_and_close)
            t.start()
            data = b""
            while chunk := cli_end.recv(1 << 16):
                data += chunk
            t.join()
        assert data[-5:-4] == b"X", data[-2000:]
        return struct.unpack("<I", data[-4:])[0]

    torch.cuda.synchronize()
    before = held()
    assert one_request() == 0
    after = held()
    grown = {k: after[k] - before.get(k, 0) for k in after}
    assert grown and all(v < (1 << 20) for v in grown.values()), (before, after)
    assert one_request() == 0
    assert held() == after


def _merge_inputs(rng, n_entries, k, id_bits, rows=3000, occ=20000, n_slots=1 << 20,
                  ranges=False):
    """(table (T, w) uint32, keys (n,) int64, entries (2, N+1) int64) numpy:
    N keyed entries of disjoint sorted random k-mer tables and position-
    sorted keys, concatenated; ranges: each entry a contiguous range of the
    k-mers (the dist shards' entries)."""
    w = -(-k // 16)
    words = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    words[:, -1] &= np.uint32(pack.last_word_mask(k))
    words = np.unique(words, axis=0)
    owner = rng.integers(0, n_entries, size=len(words))
    if ranges:
        owner = np.sort(owner)
    pos = rng.choice(n_slots, size=occ, replace=False)
    pos_owner = rng.integers(0, n_entries, size=occ)
    tables, keys = [], []
    for e in range(n_entries):
        t = words[owner == e]
        p = np.sort(pos[pos_owner == e]) if len(t) else np.zeros(0, np.int64)
        ids = rng.integers(1, len(t) + 1, size=len(p)) * rng.choice([-1, 1], size=len(p))
        tables.append(t)
        keys.append((p.astype(np.int64) << id_bits) | (ids + (1 << (id_bits - 1))))
    entries = np.cumsum([[0] + [len(x) for x in keys], [0] + [len(t) for t in tables]], axis=1)
    return np.concatenate(tables), np.concatenate(keys).astype(np.int64), entries


def _check_merge(dev, table, keys, entries, id_bits, tile=None, fan=merge.FAN_IN):
    """merge_rows and merge_keys (one launch count each) against their plain
    versions, exact; the input keys left as they were; -> the faults."""
    tab_d, keys_d, ent_d = _to(dev, table, keys, entries)
    build.reset_launch_counts()
    got = merge.merge_rows(tab_d, ent_d[1], tile=tile, fan=fan)
    assert build.launch_counts() == ({"merge_rows": 1} if len(table) else {})
    want = merge.merge_rows_plain(tab_d, ent_d[1])
    for a, b in zip(got, want):
        assert _equal(a, b)
    build.reset_launch_counts()
    got_k = merge.merge_keys(keys_d, ent_d, got[1], id_bits=id_bits, tile=tile, fan=fan)
    assert build.launch_counts() == ({"merge_keys": 1} if len(keys) else {})
    want_k = merge.merge_keys_plain(keys_d, ent_d, want[1], id_bits=id_bits)
    assert _equal(got_k[0], want_k[0]) and got_k[1].tolist() == want_k[1].tolist()
    assert np.array_equal(keys_d.cpu().numpy(), keys)
    return [int(got[2])] + got_k[1].tolist()


@pytest.mark.parametrize("tile", [None, 1, 5, 64])
@pytest.mark.parametrize("n_entries,k,id_bits,ranges", [
    (1, 25, 32, False), (2, 25, 32, False), (5, 11, 32, False), (4, 101, 24, False),
    (3, 33, 30, False), (16, 25, 32, False), (16, 25, 32, True), (40, 25, 32, False),
    (40, 11, 40, True),
])
def test_merge_kernels(dev, n_entries, k, id_bits, ranges, tile):
    """merge.cu's two entries against their plain versions, exact, at the
    default tiles and at tiles forced small (splits on run ends), on random
    and range-partitioned entries (past FAN_IN entries: rounds; fan 2:
    more rounds, FAN_MAX: one); the merge as a whole launches the two and
    no sort."""
    rng = np.random.default_rng(n_entries * k + id_bits)
    table, keys, entries = _merge_inputs(rng, n_entries, k, id_bits, ranges=ranges)
    assert _check_merge(dev, table, keys, entries, id_bits, tile=tile) == [0, 0, 0]
    if tile is None and n_entries > 2:
        for fan in (2, merge.FAN_MAX):
            assert _check_merge(dev, table, keys, entries, id_bits, fan=fan) == [0, 0, 0]
    tab_d, keys_d, ent_d = _to(dev, table, keys, entries)
    build.reset_launch_counts()
    got = merge.merge_packed(tab_d, keys_d, ent_d, key_bits=2 * k, id_bits=id_bits)
    assert build.launch_counts() == {"merge_rows": 1, "merge_keys": 1}
    want = merge.merge_packed_plain(tab_d, keys_d, ent_d, key_bits=2 * k, id_bits=id_bits)
    for a, b in zip(got, want):
        assert _equal(a, b)
    assert got[2].tolist() == [0, 0, 0]


@pytest.mark.parametrize("n_entries,ranges", [(4, False), (16, False), (16, True)])
def test_merge_kernels_large(dev, n_entries, ranges):
    """The same at the default tiles on a million keys and 200,000 rows
    (many waves of tile blocks), exact; empty inputs launch nothing."""
    rng = np.random.default_rng(n_entries)
    table, keys, entries = _merge_inputs(rng, n_entries, 25, 32, rows=200_000, occ=1_000_000,
                                         n_slots=1 << 26, ranges=ranges)
    assert _check_merge(dev, table, keys, entries, 32) == [0, 0, 0]
    empty = np.zeros((0, 2), np.uint32), np.zeros(0, np.int64), np.zeros((2, 3), np.int64)
    assert _check_merge(dev, *empty, 32) == [0, 0, 0]


def test_merge_kernels_flag_faults(dev):
    """Duplicate rows, ids of 0 and ids past their entry's table are
    counted as the plain versions count them."""
    rng = np.random.default_rng(9)
    table, keys, entries = _merge_inputs(rng, 3, 25, 32)
    # entry 1's first row also in entry 0, in its place there (the runs
    # stay sorted): one duplicate
    x = table[entries[1, 1]]
    e0 = table[: entries[1, 1]].astype(np.uint64)
    r = int(np.searchsorted(e0[:, 0] << np.uint64(32) | e0[:, 1],
                            np.uint64(x[0]) << np.uint64(32) | np.uint64(x[1]), side="right"))
    table[r] = x
    keys[[5, 17, 400]] = (keys[[5, 17, 400]] & ~0xFFFFFFFF) | (1 << 31)  # id 0
    keys[[9, 1000]] = (keys[[9, 1000]] & ~0xFFFFFFFF) | ((1 << 31) + len(table) + 3)  # past
    assert _check_merge(dev, table, keys, entries, 32) == [1, 3, 2]
    args = _to(dev, table, keys, entries)
    got = merge.merge_packed(*args, key_bits=50, id_bits=32)
    want = merge.merge_packed_plain(*args, key_bits=50, id_bits=32)
    assert got[2].tolist() == want[2].tolist() == [1, 3, 2]
    for a, b in zip(got, want):
        assert _equal(a, b)


def test_merge_path_on_the_card(dev, tmp_path):
    """-r 3 on the card merges its three keyed rounds with merge.cu's two
    entries, -r 1 with neither; a free-memory figure below the merge's buffers
    takes the host merge: every .dbg the same."""
    sequences = _dist_inputs()
    outs = []
    for rounds in (1, 3):
        cfg = PipelineConfig(k=25, rounds=rounds, positions_per_row=256, rows_per_batch=8)
        out = str(tmp_path / f"r{rounds}.dbg")
        build.reset_launch_counts()
        build_junctions_sorted(None, cfg, out, sequences=sequences, device="cuda")
        counts = build.launch_counts()
        assert (counts.get("merge_rows", 0), counts.get("merge_keys", 0)) == (
            (0, 0) if rounds == 1 else (1, 1)), counts
        outs.append(open(out, "rb").read())
    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=fetched, batches=batches)
        return orig(fetched, batches, *a, **kw)

    sortpipe.merge_fetched = capture
    try:
        build_junctions_sorted(None, cfg, None, sequences=sequences, device="cuda")
    finally:
        sortpipe.merge_fetched = orig
    lines = []
    out = str(tmp_path / "host.dbg")
    sortpipe.merge_fetched(got["fetched"], got["batches"], cfg, out, sortpipe.RunStats(),
                           lines.append, n_slots=len(got["batches"]) * 8 * 256,
                           wide=False, n_sequences=len(sequences), dev=dev, free=1)
    assert any("Merge on the host" in s for s in lines)
    outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > 0


# ---- the card emit (emit.cu): the one keyed entry's records on the card

EMIT_CASES = [  # (lengths, k, P, B, id_bits, at the sequences' ends, chunk)
    ("mixed", 11, 64, 4, 32, "random", 1 << 24),  # one chunk
    ("mixed", 11, 64, 4, 32, "random", 97),  # 3 chunks
    ("many", 11, 64, 4, 24, "stubs", 3),  # many chunks; edges on stubs and separators
    ("many", 11, 64, 4, 32, "none", 1),  # a chunk an occurrence
    ("runs", 11, 64, 4, 32, "stubs", 1 << 24),  # stub runs wider than a block's stage
    ("runs", 11, 100, 4, 32, "random", 1000),  # P not a power of two
    ("long", 25, 16384, 128, 32, "random", 1 << 20),  # the cell's layout, ~2.2 M keys
]


def _emit_case(dev, case, n_table=5000):
    kind, k, P, B, id_bits, at_ends, chunk_occ = case
    batches = emit_cases.batches(emit_cases.lengths(kind, k), k, P, B)
    keys = emit_cases.keys(batches, P, id_bits, n_table, at_ends)
    return batches, keys, torch.from_numpy(keys.view(np.int64)).to(dev), P, id_bits, chunk_occ


@pytest.mark.parametrize("case", EMIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emit_kernels(dev, tmp_path, case):
    """tp_emit_check and tp_emit_chunk against their plain versions on
    every chunk (outputs filled differently first, so a word either
    leaves unwritten differs), and the file against the plain emit's of a
    CPU copy of the keys."""
    batches, keys, kd, P, id_bits, chunk_occ = _emit_case(dev, case)
    n_table = 5000
    build.reset_launch_counts()
    found = emit.check_keys(kd, batches, n_table, P, id_bits, chunk_occ=chunk_occ)
    assert build.launch_counts() == {"emit_check": 1}
    plain = emit.check_keys(kd, batches, n_table, P, id_bits, chunk_occ=chunk_occ,
                            fn=emit.check_plain)
    for name in ("queries", "lower", "hit", "edge_keys"):
        assert np.array_equal(getattr(found, name), getattr(plain, name)), name
    pl = emit.plan(batches, found, len(keys), n_table, P, id_bits)
    rows, gs, gr = (torch.from_numpy(a).to(dev) for a in (pl.rows, pl.gap_slots, pl.gap_recs))
    for i0, i1, s0, s1 in pl.bounds:
        got = torch.full((3 * (s1 - s0),), -7, dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        emit.chunk(kd, rows, gs, gr, got, i0=i0, i1=i1, s0=s0, P=P, id_bits=id_bits)
        emit.chunk_plain(kd, rows, gs, gr, want, i0=i0, i1=i1, s0=s0, P=P, id_bits=id_bits)
        assert torch.equal(got, want), (i0, i1, s0, s1)
    build.reset_launch_counts()
    card = str(tmp_path / "card.dbg")
    got_n = emit.write_keys(card, batches, kd, found, n_table, P, id_bits)
    assert build.launch_counts() == {"emit_chunk": len(pl.bounds)}
    host = str(tmp_path / "host.dbg")
    kc = torch.from_numpy(keys.view(np.int64))
    plain = emit.check_keys(kc, batches, n_table, P, id_bits, fn=emit.check_plain)
    want_n = emit.write_keys(host, batches, kc, plain, n_table, P, id_bits, fn=emit.chunk_plain)
    assert got_n == want_n
    assert open(card, "rb").read() == open(host, "rb").read()


@pytest.mark.parametrize("what", ["id 0", "past", "position", "order"])
def test_emit_check_counts_faults(dev, tmp_path, what):
    """Each planted fault counted as the plain version counts it, and
    raised before the output exists."""
    batches, keys, _kd, P, id_bits, _c = _emit_case(dev, EMIT_CASES[-1])
    mask = np.uint64((1 << id_bits) - 1)
    i = len(keys) // 2
    if what in ("id 0", "past"):
        bad = 0 if what == "id 0" else 5001
        keys[i] = (keys[i] & ~mask) | np.uint64(bad + (1 << (id_bits - 1)))
    elif what == "position":
        keys[-1] = (keys[-1] & mask) | (np.uint64(len(emit_cases.valid_flats(batches, P)) * P)
                                        << np.uint64(id_bits))
    else:
        keys[[i, i + 1]] = keys[[i + 1, i]]
    kd = torch.from_numpy(keys.view(np.int64)).to(dev)
    args = (kd, torch.from_numpy(np.concatenate([b.valid for b in batches])).to(dev),
            torch.arange(0, 4096 * P, P, device=dev), torch.tensor([0, len(keys) - 1, -1],
                                                                  device=dev))
    got = emit.check(*args, P=P, id_bits=id_bits, n_table=5000)
    want = emit.check_plain(*args, P=P, id_bits=id_bits, n_table=5000)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) >= 1
    with pytest.raises(RuntimeError, match="occurrence"):
        emit.check_keys(kd, batches, 5000, P, id_bits)


def _emit_write(root):
    (write,) = [s for s in trace.descendants(root) if s.name == "emit_write"]
    return write


@pytest.mark.parametrize("engine", ["sort", "dist", "bloom"])
def test_one_round_emits_on_the_card(dev, tmp_path, engine):
    """Sort -r 1 and dist over the card's one shard keep their keys on
    the card and write the CPU run's bytes there (card_records: every
    record but the separators); -r 3 and 4 shards merge their entries on
    the card and write the merged keys there too; the Bloom engine's pass
    4 keys, at -r 1 and -r 3, stay on the card and take the same emit; the
    CPU run takes the same emit's plain versions, which count its records
    too. A card run launches emit_check once and emit_chunk at least
    once."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, positions_per_row=256, rows_per_batch=8)
    if engine == "bloom":
        cfg = dataclasses.replace(cfg, engine="bloom", filter_bits=20)
    runs = {"cpu": ("cpu", 1, 1), "card": (dev, 1, 1), "r3": (dev, 3, 1),
            "shards": (dev, 1, 4)}
    outs = {}
    for name, (device, rounds, shards) in runs.items():
        if engine != "dist" and shards > 1:
            continue
        c = dataclasses.replace(cfg, rounds=rounds)
        out = str(tmp_path / f"{name}.dbg")
        build.reset_launch_counts()
        with trace.span("twopaco") as root:
            if engine == "dist":
                enum = distpipe.build_junctions_dist(None, c, LocalMesh([device] * shards), out,
                                                     sequences=sequences, device=device)
            elif engine == "bloom":
                enum = build_junctions(None, c, out, sequences=sequences, device=device)
            else:
                enum = build_junctions_sorted(None, c, out, sequences=sequences, device=device)
        outs[name] = open(out, "rb").read()
        card = _emit_write(root).counters["card_records"]
        assert card == enum.stats.occurrences > 0, name
        if name != "cpu":
            counts = build.launch_counts()
            assert counts.get("emit_check") == 1 and counts.get("emit_chunk", 0) >= 1, counts
    assert len(set(outs.values())) == 1 and len(outs["cpu"]) > 0


def test_merged_rounds_emit_on_the_card(dev, tmp_path):
    """-r 4 of the 8 x 1 Mbase input merges its four keyed rounds on the
    card and writes the merged keys through emit.cu: the bytes of -r 1 and
    of the plain versions (reference=True) on the card, the JAX-confirmed
    sha256, card_records = the records; and the emit stays under the
    rounds' peak: max_memory_allocated no higher than the same build with
    no output."""
    fa = bench_data.write_bench_fasta(str(tmp_path / "in.fa"), 8, 1_000_000, 2016)
    cfg = PipelineConfig(k=25)
    for name, rounds, reference in (("r1", 1, False), ("plain", 4, True), ("r4", 4, False)):
        out = str(tmp_path / f"{name}.dbg")
        with trace.span("twopaco") as root:
            enum = build_junctions_sorted([fa], dataclasses.replace(cfg, rounds=rounds), out,
                                          device="cuda", reference=reference)
        assert _file_sha(out) == _golden_sha("bench_8x1M_k25"), name
        assert _emit_write(root).counters["card_records"] == enum.stats.occurrences > 0, name
    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, *a, **kw):
        got["keys"] = [len(e[1]) for e in fetched]
        return orig(fetched, *a, **kw)

    peaks = {}
    sortpipe.merge_fetched = capture
    try:
        for out in (None, str(tmp_path / "peak.dbg")):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            build_junctions_sorted([fa], dataclasses.replace(cfg, rounds=4), out,
                                   device="cuda")
            torch.cuda.synchronize()
            peaks[out is not None] = torch.cuda.max_memory_allocated()
    finally:
        sortpipe.merge_fetched = orig
    print(f"-r 4 peak: {peaks[True]} bytes with the output, {peaks[False]} without; the "
          f"rounds' keys {[8 * n for n in got['keys']]} bytes")
    assert peaks[True] <= peaks[False]


def test_card_emit_chunks_fit_the_free_memory(dev, tmp_path):
    """-r 1 on the card with little free device memory: the emit runs in
    smaller chunks (one emit_chunk launch each) on the card and writes
    the same bytes; sequence ids that fall raise before the output
    exists."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, positions_per_row=256, rows_per_batch=8)
    want = str(tmp_path / "want.dbg")
    build_junctions_sorted(None, cfg, want, sequences=sequences, device="cpu")
    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=fetched, batches=batches)
        return orig(fetched, batches, *a, **kw)

    sortpipe.merge_fetched = capture
    try:
        build_junctions_sorted(None, cfg, None, sequences=sequences, device="cuda")
    finally:
        sortpipe.merge_fetched = orig
    (table, keys, _none), = got["fetched"]
    assert isinstance(keys, occ.OccKeys) and keys.keys.is_cuda
    n = len(keys)
    for chunk_occ in (max(n // 50, 1), n // 3 + 1):
        free = emit.table_bytes(got["batches"]) + 2 * 12 * chunk_occ
        out, lines = str(tmp_path / f"c{chunk_occ}.dbg"), []
        build.reset_launch_counts()
        sortpipe.merge_rounds_packed(got["fetched"], got["batches"], cfg, out,
                                     sortpipe.RunStats(), lines.append, dev=dev, free=free)
        assert build.launch_counts() == {"emit_check": 1, "emit_chunk": -(-n // chunk_occ)}
        assert any(f"Emit in chunks of {chunk_occ}" in s for s in lines)
        assert open(out, "rb").read() == open(want, "rb").read()
    out = tmp_path / "falling.dbg"
    with pytest.raises(ValueError, match="input order"):
        build_junctions_sorted(None, cfg, str(out), device="cuda",
                               sequences=[(3 - i, c) for i, c in sequences])
    assert not out.exists()


def test_one_round_checkpoint_on_the_card(dev, tmp_path):
    """-r 1 on the card with a checkpoint directory: the round's file
    holds what the CPU run's holds, and a resume writes the same bytes."""
    sequences = _dist_inputs()
    cfg = PipelineConfig(k=25, positions_per_row=256, rows_per_batch=8)
    files = {}
    for device in ("cpu", "cuda"):
        ck = str(tmp_path / f"ck_{device}")
        out = str(tmp_path / f"{device}.dbg")
        build_junctions_sorted(None, cfg, out, sequences=sequences, device=device,
                               checkpoint_dir=ck)
        files[device] = np.load(os.path.join(ck, "round_0.npz"))
        again = str(tmp_path / f"{device}_again.dbg")
        build_junctions_sorted(None, cfg, again, sequences=sequences, device=device,
                               checkpoint_dir=ck)
        assert open(again, "rb").read() == open(out, "rb").read()
    for name in ("table", "occ_pos", "occ_ids"):
        a, b = files["cpu"][name], files["cuda"][name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
