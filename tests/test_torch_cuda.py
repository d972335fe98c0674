"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped on hosts without a CUDA device. Run on a GPU host with:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX, which a GPU host need
not have; this file imports no JAX.) Integer data: every comparison is
exact.
"""

import os

import numpy as np
import pytest
import torch

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.io import junctions, windows
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import bloom, pack
from twopaco_tpu_torch.parallel import distpipe, sharded, sortshard
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.passes import (
    extract, fill, histogram, judge, lookup, mark, occ, partition, records, route,
    shardbloom, sort, stream,
)
from twopaco_tpu_torch.passes.pipeline import PassConfig, PipelineConfig, build_junctions
from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted
from twopaco_tpu_torch.testing import oracle

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
            assert set(counts) == {"build_records", "sort_records", "judge_compact",
                                   "sort_occurrences"}
    assert outs[0] == outs[1] and len(outs[0]) > 0


def _upload_batches(dev, rng, nb, B, P, k):
    return [_to(dev, *_genome_batch(rng, B, P, k)) for _ in range(nb)]


@pytest.mark.parametrize(
    "k,n_parts,cap,gate",
    [(25, 4, 1200, "full"), (25, 1, 5000, "full"), (11, 7, 150, "full"),
     (33, 5, 900, "narrow"), (101, 3, 64, "full"), (25, 300, 8, "full")],
)
def test_partition_kernel(dev, k, n_parts, cap, gate):
    """Blocks, counts and sentinel slots equal the plain version exactly,
    overflowing caps (150, 64, 8) included."""
    rng = np.random.default_rng(k * 31 + n_parts)
    B, P = 8, 512
    args = _to(dev, *_genome_batch(rng, B, P, k))
    low, high = (0, 0xFFFFFFFF) if gate == "full" else (1 << 30, 3 << 30)
    cuts = np.sort(rng.integers(low, high, size=n_parts - 1))
    highs = pack.as_u32(torch.tensor(np.append(cuts, high), device=dev))
    build.reset_launch_counts()
    got = partition.partition_batch(*args, highs, low, high, k=k, P=P, part_cap=cap)
    assert build.launch_counts() == {"partition": 1}
    want = partition.partition_batch_plain(*args, highs, low, high, k=k, P=P, part_cap=cap)
    for a, b in zip(got, want):
        assert _equal(a, b)
    assert int(want[3].sum()) > 0


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
@pytest.mark.parametrize("slots_per_batch", [100, 2048])  # 100 overflows
def test_compact_kernel(dev, k, slots_per_batch):
    """compact_append over several batches: the buffer and the (offset,
    overflow) state equal the plain version's exactly."""
    rng = np.random.default_rng(k + slots_per_batch)
    B, P, nb = 4, 256, 5
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
    assert int(outs[0][3][1]) == (slots_per_batch == 100)


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
        got = lookup.pass4_lookup(*u, m, tab, cap, k=k, P=P)
        assert build.launch_counts() == ({} if table == "empty" else {"bloom_lookup": 1})
        want = lookup.pass4_lookup_plain(*u, m, tab, cap, k=k, P=P)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
    assert (int(want[2]) > 0) == (table != "empty")


def test_bloom_wrappers_never_reach_the_plain_code(dev, monkeypatch):
    """A CUDA tensor given to a Bloom wrapper launches its kernel: the
    plain versions, made to raise here, are never called."""
    def boom(*a, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((fill, "bloom_fill_plain"), (mark, "bloom_mark_plain"),
                      (extract, "extract_records_plain"), (lookup, "pass4_lookup_plain")):
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(5)
    k, B, P = 25, 8, 256
    u = _to(dev, *_genome_batch(rng, B, P, k))
    build.reset_launch_counts()
    for layout, f in (("byte", 18), ("bit", 18), ("block", 18)):
        cfg = PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=B)
        filt = fill.bloom_fill(bloom.make_filter(f, layout, dev), *u, 0, 0xFFFFFFFF, cfg=cfg)
        m, c = mark.bloom_mark(filt, *u, 0, 0xFFFFFFFF, cfg=cfg)
    buf, state = extract.extract_records(
        u[0], u[1], m, *extract.new_buffer(int(c), pack.n_words(k), dev), 0, k=k, P=P)
    tab = judge.judge_compact(*sort.sort_records(*buf, key_bits=2 * k))[0]
    lookup.pass4_lookup(*u, m, tab, int(c), k=k, P=P)
    assert build.launch_counts() == {
        "bloom_fill": 3, "bloom_mark": 3, "bloom_extract": 1, "sort_records": 1,
        "judge_compact": 1, "bloom_lookup": 1,
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
        build_junctions(None, cfg, out, sequences=sequences, device=device)
        outs.append(open(out, "rb").read())
        if device == "cuda":
            assert set(build.launch_counts()) == {
                "bloom_fill", "bloom_mark", "bloom_extract", "sort_records",
                "judge_compact", "bloom_lookup",
            }
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
    want = sortshard.sharded_sort_step(mesh, scfg, ops=sortshard.PLAIN)(
        batch, 0, 0xFFFFFFFF, NO_AB)
    assert got[1:] == want[1:] and got[1] > 0 and got[3] == 0
    for s in mesh.shards:
        for a, b_ in zip(got[0][s], want[0][s]):
            assert _equal(a, b_)


@pytest.mark.parametrize("rounds", [1, 2])
def test_dist_engine_cuda_equals_plain(dev, tmp_path, rounds):
    """build_junctions_dist on a LocalMesh of 4 shards of one card: the
    kernels' .dbg equals the plain run's and the sort engine's."""
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
            want = {"word0_histogram", "build_records", "route", "compact", "sort_records",
                    "judge_compact", "sort_occurrences"} | ({"histogram"} if rounds > 1 else set())
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
    for ops in (sortshard.KERNELS, sortshard.PLAIN):
        filt = sharded.make_sharded_filter(mesh, scfg)
        fill_step = sharded.sharded_fill_step(mesh, scfg, ops)
        mark_step = sharded.sharded_mark_step(mesh, scfg, ops)
        build.reset_launch_counts()
        over = None
        for b in batches:
            over = fill_step(filt, b, low, high, over)
        marked = [mark_step(filt, b, low, high) for b in batches]
        counts = build.launch_counts()
        if ops is sortshard.KERNELS:
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


def test_shard_probe_and_mark_finish_unsent_probes(dev):
    """Probes past a tiny cap are not sent and read as misses, in the
    kernels as in the plain versions (the counts may then differ from a
    full cap's, and the engine raises on the overflow)."""
    k, P, q, D = 25, 256, 3, 4
    rng = np.random.default_rng(3)
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
    engine's."""
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
            want = {"word0_histogram", "shard_bucket_fill", "shard_bucket_mark", "shard_fill",
                    "shard_probe", "shard_mark_finish", "build_records", "route", "compact",
                    "sort_records", "judge_compact", "sort_occurrences"} | ({"histogram"} if rounds > 1 else set())
            assert set(counts) == want, counts
    sort_out = str(tmp_path / "sort.dbg")
    build_junctions_sorted(None, cfg, sort_out, sequences=sequences, device="cuda")
    assert outs[0] == outs[1] == open(sort_out, "rb").read() and len(outs[0]) > 0
