"""Port ops (plain PyTorch) against the JAX package: pack and buzhash.

Seeded numpy inputs go through both; integer data, so every comparison
is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu.ops import buzhash as jbz
from twopaco_tpu.ops import pack as jpack
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, config_from_jax

KS = [11, 25, 33, 101]


def _codes(k, rows=3, length=None, seed=0):
    """(rows, length) uint8 codes 0..4 with N runs."""
    rng = np.random.default_rng(seed + k)
    length = length or 2 * k + 40
    c = rng.integers(0, 4, size=(rows, length)).astype(np.uint8)
    for r in range(rows):
        a = int(rng.integers(0, length - 5))
        c[r, a : a + int(rng.integers(1, 5))] = 4
    c[rng.random(c.shape) < 0.02] = 4
    return c


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.cpu().numpy().astype(np.int64)


def test_tables_equal_jax():
    assert (bz.TABLE_1, bz.TABLE_2, bz.TABLE_3, bz.TABLE_4) == (
        jbz.TABLE_1, jbz.TABLE_2, jbz.TABLE_3, jbz.TABLE_4,
    )


def test_config_from_jax():
    jc = JaxConfig(
        k=31, filter_bits=30, hash_functions=3, rounds=1, abundance=7,
        positions_per_row=256, rows_per_batch=4,
    )
    # the JAX sort_chunk default (2^26) crosses as it is; the port's own
    # default, None, sizes rounds from the device's memory; the Bloom
    # engine's fields cross too
    assert config_from_jax(jc) == PipelineConfig(
        k=31, rounds=1, abundance=7, positions_per_row=256, rows_per_batch=4,
        sort_chunk=1 << 26, filter_bits=30, hash_functions=3,
    )
    bloom = JaxConfig(k=9, filter_bits=34, hash_functions=4, layout="block", engine="bloom")
    assert config_from_jax(bloom) == PipelineConfig(
        k=9, sort_chunk=1 << 26, filter_bits=34, hash_functions=4, layout="block",
        engine="bloom",
    )
    assert config_from_jax(JaxConfig(k=25)) == PipelineConfig(k=25, sort_chunk=1 << 26)
    multi = JaxConfig(k=9, rounds=3, sort_chunk=4096, round_slack=1.5, force_wide=True)
    assert config_from_jax(multi) == PipelineConfig(
        k=9, rounds=3, sort_chunk=4096, round_slack=1.5, force_wide=True,
    )
    assert PipelineConfig(k=25).sort_chunk is None


@pytest.mark.parametrize("k", KS)
def test_kmer_and_revcomp_words(k):
    codes = _codes(k)
    cm = np.where(codes < 4, codes, 0).astype(np.uint32)
    n_out = codes.shape[1] - k + 1
    jw = jpack.kmer_words(jnp.asarray(cm), k, n_out)
    tw = pack.kmer_words(torch.from_numpy(cm.astype(np.int64)), k, n_out)
    assert np.array_equal(_np(jw), _t(tw))
    assert np.array_equal(_np(jpack.revcomp_words(jw, k)), _t(pack.revcomp_words(tw, k)))
    jc, jrc = jpack.canonical(jw, jpack.revcomp_words(jw, k))
    tc, trc = pack.canonical(tw, pack.revcomp_words(tw, k))
    assert np.array_equal(_np(jc), _t(tc))
    assert np.array_equal(np.asarray(jrc), trc.numpy())


@pytest.mark.parametrize("k", KS)
def test_window_all_definite(k):
    codes = _codes(k, seed=1)
    n_out = codes.shape[1] - k + 3  # past the end: pad counts as N
    j = jpack.window_all_definite(jnp.asarray(codes), k, n_out)
    t = pack.window_all_definite(torch.from_numpy(codes), k, n_out)
    assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("k", KS)
def test_pack_codes_host_and_unpack(k):
    codes = _codes(k, rows=4, length=k + 71, seed=2)
    jp, jm = jpack.pack_codes_host(codes)
    tp, tm = pack.pack_codes_host(codes)
    assert np.array_equal(jp, tp) and np.array_equal(jm, tm)
    R = codes.shape[1]
    t = pack.unpack_codes(torch.from_numpy(tp), torch.from_numpy(tm), R)
    assert np.array_equal(np.asarray(jpack.unpack_codes(jnp.asarray(jp), jnp.asarray(jm), R)), t.numpy())
    assert np.array_equal(t.numpy(), codes)


@pytest.mark.parametrize("k", KS)
def test_hash_scans_and_window_hashes(k):
    codes = _codes(k, seed=3)
    n_out = codes.shape[1] - k + 1
    js = jbz.hash_scans(jnp.asarray(codes), jbz.TABLE_1)
    ts = bz.hash_scans(torch.from_numpy(codes), bz.TABLE_1)
    for a, b in zip(js, ts):
        assert np.array_equal(_np(a), _t(b))
    jh = jbz.window_hashes(*js, k, n_out)
    th = bz.window_hashes(*ts, k, n_out)
    for a, b in zip(jh, th):
        assert np.array_equal(_np(a), _t(b))
    # direct evaluation of one window's forward hash
    c0 = codes[0, 5 : 5 + k]
    assert int(th[0][0, 5]) == jbz.window_hash_ref(c0, jbz.TABLE_1)


def test_u32_views_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = pack.as_i64(torch.from_numpy(x))
    assert t.tolist() == [int(v) for v in x]
    assert np.array_equal(pack.as_u32(t).numpy(), x)
    idx = torch.tensor([4, 0, 3])
    assert np.array_equal(pack.take_u32(torch.from_numpy(x), idx).numpy(), x[[4, 0, 3]])
