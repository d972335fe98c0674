"""The multi-round device steps of the port against twopaco_tpu, on the
CPU (the plain versions):

  - partition_batch    vs sortpipe.build_and_partition
  - assemble_round     vs sortpipe.assemble_round (narrow and wide)
  - stream_round       vs sortpipe._stream_round_scan (compact + append)
  - histogram_*        vs kernels.histogram_vertex_hashes, _histogram_scan

Seeded numpy batches of a few related genomes (N runs, short rows) go to
both; integer data, so the comparisons are exact. build_and_partition
orders a round's records with lax.sort, which is not stable: its blocks
are compared once their live rows are ordered by offset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import histogram, partition, stream

B, P = 4, 256
MASK32 = 0xFFFFFFFF


def _batches(k, seed, nb=3):
    """[(packed, nmask, valid)] numpy batches cut from related genomes."""
    rng = np.random.default_rng(seed)
    R = P + k + 1
    base = rng.integers(0, 4, size=3 * R).astype(np.uint8)
    out = []
    for _ in range(nb):
        codes = np.stack([base[s : s + R] for s in rng.integers(0, 2 * R, size=B)])
        flip = rng.random(codes.shape) < 0.02
        codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
        codes[rng.random(codes.shape) < 0.005] = 4
        valid = rng.integers(0, P + 1, size=B).astype(np.int32)
        valid[0] = P
        out.append((*pack.pack_codes_host(codes), valid))
    return out


def _cfg(k):
    return jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _highs(n_parts, low, high):
    return np.linspace(low, high, n_parts + 1).astype(np.int64)[1:]


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("n_parts,gate", [(1, "full"), (3, "full"), (3, "narrow")])
def test_partition_matches_jax(k, n_parts, gate):
    packed, nmask, valid = _batches(k, seed=k + n_parts)[0]
    low, high = (0, MASK32) if gate == "full" else (0x30000000, 0xB0000000)
    highs = _highs(n_parts, low, high)
    cap = B * P  # roomy: every record fits
    jw, jp, (joff,), jc = jsort.build_and_partition(
        (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
        jsort._pos_base(0, P, False), jnp.asarray(highs.astype(np.uint32)),
        jnp.uint32(low), jnp.uint32(high), cfg=_cfg(k), n_parts=n_parts, part_cap=cap,
    )
    build.reset_launch_counts()
    tw, tp, toff, tc = partition.partition_batch(
        *_t((packed, nmask, valid)), pack.as_u32(torch.from_numpy(highs)),
        low, high, k=k, P=P, part_cap=cap,
    )
    assert build.launch_counts() == {}  # CPU tensors: the plain version
    jc, tc = np.asarray(jc), tc.numpy()
    assert np.array_equal(tc, jc) and tc.sum() > 0
    jw, jp, joff = np.asarray(jw), np.asarray(jp), np.asarray(joff)
    for r in range(n_parts):
        n = tc[r]
        o = np.argsort(joff[r, :n])
        assert np.array_equal(tw.numpy()[r, :n], jw[r, :n][o])
        assert np.array_equal(tp.numpy()[r, :n], jp[r, :n][o])
        assert np.array_equal(toff.numpy()[r, :n], joff[r, :n][o])
        assert np.all(np.diff(toff.numpy()[r, :n].astype(np.int64)) > 0)  # stable
        for t, j in ((tw, jw), (tp, jp), (toff, joff)):  # sentinel slots
            assert np.array_equal(t.numpy()[r, n:], j[r, n:])


def test_partition_overflow_counts_and_keeps_the_first():
    """A cap below a round's count: the counts are the true counts, and
    the block holds the round's first records in in-batch order."""
    k, n_parts, cap = 25, 2, 100
    packed, nmask, valid = _batches(k, seed=5)[0]
    highs = _highs(n_parts, 0, MASK32)
    args = (*_t((packed, nmask, valid)), pack.as_u32(torch.from_numpy(highs)), 0, MASK32)
    jc = jsort.build_and_partition(
        (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
        jsort._pos_base(0, P, False), jnp.asarray(highs.astype(np.uint32)),
        jnp.uint32(0), jnp.uint32(MASK32), cfg=_cfg(k), n_parts=n_parts, part_cap=cap,
    )[3]
    tw, tp, toff, tc = partition.partition_batch(*args, k=k, P=P, part_cap=cap)
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and (tc.numpy() > cap).all()
    full = partition.partition_batch(*args, k=k, P=P, part_cap=B * P)
    for got, want in zip((tw, tp, toff), full[:3]):
        assert torch.equal(got.view(torch.int32), want[:, :cap].view(torch.int32))


def _stacked_blocks(k, n_parts, cap, nb=3):
    batches = _batches(k, seed=40 + k, nb=nb)
    highs = _highs(n_parts, 0, MASK32)
    return partition.partition_scan(
        [_t(b) for b in batches], highs, 0, MASK32, k=k, P=P, part_cap=cap,
    )


@pytest.mark.parametrize("wide", [False, True])
def test_assemble_round_matches_jax(wide):
    k, n_parts, cap, nb = 25, 3, 400, 3
    blk_w, blk_pay, blk_off, counts = _stacked_blocks(k, n_parts, cap, nb)
    assert (counts <= cap).all()
    row0 = np.array([0, 70_000_000, 70_000_000 + B]) if wide else np.arange(nb) * B
    bases = row0 * P  # past 2^32 when wide
    base_cols = [jsort._pos_base(int(r), P, wide) for r in row0]
    base_st = tuple(jnp.stack([c[i] for c in base_cols]) for i in range(len(base_cols[0])))
    buf_slots = nb * cap + 300
    for r in range(n_parts):
        jw, jp, jpos = jsort.assemble_round(
            jnp.int32(r), jnp.asarray(blk_w.numpy()), jnp.asarray(blk_pay.numpy()),
            (jnp.asarray(blk_off.numpy()),), base_st, buf_slots=buf_slots,
        )
        tw, tp, tpos = partition.assemble_round(
            r, blk_w, blk_pay, blk_off, torch.from_numpy(bases), buf_slots,
        )
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(tpos.numpy(), jsort._host_pos(jpos))


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("room", ["fits", "overflows"])
def test_stream_round_matches_jax(k, room):
    """Build gated to the round, compact, append at a running offset:
    the whole buffer (sentinel tail included) and the overflow flag."""
    batches = _batches(k, seed=60 + k, nb=4)
    low, high = 0x40000000, 0x9FFFFFFF
    bp = B * P
    buf_slots = 4 * bp if room == "fits" else bp + 200
    codes_st = tuple(jnp.asarray(np.stack([b[i] for b in batches])) for i in (0, 1))
    valid_st = jnp.asarray(np.stack([b[2] for b in batches]))
    base_st = (jnp.asarray((np.arange(4) * bp).astype(np.uint32)),)
    jw, jp, (jpos,), jover = jsort._stream_round_scan(
        codes_st, valid_st, base_st, jnp.uint32(low), jnp.uint32(high),
        cfg=_cfg(k), buf_slots=buf_slots,
    )
    build.reset_launch_counts()
    tw, tp, tpos, tover = stream.stream_round(
        [_t(b) for b in batches], [i * bp for i in range(4)], low, high,
        k=k, P=P, buf_slots=buf_slots,
    )
    assert build.launch_counts() == {}
    assert tover == bool(jover) == (room == "overflows")
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos).astype(np.int64))


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("stride", [1, 4])
def test_histogram_matches_jax(k, stride):
    packed, nmask, valid = _batches(k, seed=80 + k)[0]
    want = np.asarray(jkernels.histogram_vertex_hashes(
        (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
        cfg=_cfg(k), stride=stride,
    ))
    got = histogram.histogram_vertex_hashes(*_t((packed, nmask, valid)), k=k, P=P, stride=stride)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("stride", [1, 4])
def test_histogram_batches_matches_jax(stride):
    """The batched entry (histogram_scan's; on the CPU the per-batch plain
    function over the batches) equals the sum of JAX's per-batch
    histogram_vertex_hashes: five batches, different valid counts, one
    with no valid position."""
    k = 25
    batches = _batches(k, seed=95, nb=5)
    batches[3][2][:] = 0
    want = sum(np.asarray(jkernels.histogram_vertex_hashes(
        (jnp.asarray(p), jnp.asarray(m)), jnp.asarray(v), cfg=_cfg(k), stride=stride,
    )).astype(np.int64) for p, m, v in batches)
    uploads = [_t(b) for b in batches]
    for fn in (histogram.histogram_vertex_hashes_batches,
               histogram.histogram_vertex_hashes_batches_plain):
        got = fn(uploads, k=k, P=P, stride=stride)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_histogram_scan_matches_jax():
    k = 25
    batches = _batches(k, seed=90, nb=3)
    codes_st = tuple(jnp.asarray(np.stack([b[i] for b in batches])) for i in (0, 1))
    valid_st = jnp.asarray(np.stack([b[2] for b in batches]))
    for stride in (1, 4):
        want = jsort._histogram_scan(codes_st, valid_st, cfg=_cfg(k), stride=stride)
        got = histogram.histogram_scan([_t(b) for b in batches], k=k, P=P, stride=stride)
        assert np.array_equal(got, np.asarray(want))
