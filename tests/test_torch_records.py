"""Port record build against twopaco_tpu sortpipe.build_sort_records.

Seeded numpy batches (genome-like rows with N runs) go through the JAX
function and the port (CPU tensors: the plain version); integer data,
so words, payload and positions must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import records

B, P = 8, 128
GATES = {"full": (0, 0xFFFFFFFF), "narrow": (0x40000000, 0xA0000000)}


def _batch(k, seed):
    rng = np.random.default_rng(seed)
    R = P + k + 1
    base = rng.integers(0, 4, size=2 * R).astype(np.uint8)
    codes = np.stack([base[s : s + R] for s in rng.integers(0, R, size=B)])
    flip = rng.random(codes.shape) < 0.02
    codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
    codes[rng.random(codes.shape) < 0.01] = 4
    valid = rng.integers(0, P + 1, size=B).astype(np.int32)
    valid[:2] = P
    return pack.pack_codes_host(codes), valid


def _jax_records(packed, nmask, valid, row0, k, low, high):
    cfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    words, pay, pos = jsort.build_sort_records(
        (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
        jsort._pos_base(row0, P, False), jnp.uint32(low), jnp.uint32(high),
        cfg=cfg,
    )
    return np.asarray(words), np.asarray(pay), np.asarray(pos[0]).astype(np.int64)


@pytest.mark.parametrize("k", [11, 25, 101])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_build_sort_records_matches_jax(k, gate):
    (packed, nmask), valid = _batch(k, seed=k)
    low, high = GATES[gate]
    row0 = 3 * B
    jw, jp, jpos = _jax_records(packed, nmask, valid, row0, k, low, high)
    build.reset_launch_counts()
    tw, tp, tpos = records.build_sort_records(
        torch.from_numpy(packed), torch.from_numpy(nmask),
        torch.from_numpy(valid), row0 * P, k=k, P=P, low=low, high=high,
    )
    assert build.launch_counts() == {}  # CPU tensors: the plain version
    assert tw.dtype == torch.uint32 and tp.dtype == torch.uint32
    assert np.array_equal(tw.numpy(), jw)
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(tpos.numpy(), jpos)
    real = (jp >> 17) & 1
    assert 0 < real.sum() < B * P  # both real rows and sentinels occur


def test_build_writes_into_round_buffer():
    k = 25
    (packed, nmask), valid = _batch(k, seed=7)
    n = B * P
    buf = (
        torch.full((3 * n, 2), 7, dtype=torch.uint32),
        torch.zeros(3 * n, dtype=torch.uint32),
        torch.zeros(3 * n, dtype=torch.int64),
    )
    out = tuple(t[n : 2 * n] for t in buf)
    got = records.build_sort_records(
        torch.from_numpy(packed), torch.from_numpy(nmask),
        torch.from_numpy(valid), n, k=k, P=P, out=out,
    )
    want = _jax_records(packed, nmask, valid, B, k, *GATES["full"])
    assert np.array_equal(buf[0][n : 2 * n].numpy(), want[0])
    assert np.array_equal(buf[2][n : 2 * n].numpy(), want[2])
    assert (buf[0][:n].numpy() == 7).all()  # nothing outside the slice
    assert got is out
