"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped on hosts without a CUDA device. Run on a GPU host with:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX, which a GPU host need
not have; this file imports no JAX.) Integer data: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import judge, records, sort
from twopaco_tpu_torch.passes.pipeline import PipelineConfig
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
    got = sort.sort_records(*args)
    assert build.launch_counts() == {"sort_records": 1}
    want = sort.sort_records_plain(*args)
    for a, b in zip(got, want):
        assert _equal(a, b)


@pytest.mark.parametrize("m,w", [(1, 2), (5000, 2), (200_001, 2), (40_000, 7)])
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_kernel(dev, m, w, abundance):
    rng = np.random.default_rng(m * 7 + w)
    sw, spay, spos = sort.sort_records_plain(
        *_to(dev, *_random_records(rng, m, w, dup_frac=0.8))
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
    srt = sort.sort_records(*recs)
    for a, b in zip(srt, sort.sort_records_plain(*recs)):
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
    sw, spay, spos = sort.sort_records(words, e32, pos)
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
            assert set(counts) == {"build_records", "sort_records", "judge_compact"}
    assert outs[0] == outs[1] and len(outs[0]) > 0
