"""The port's hash-sharded Bloom filter (parallel/sharded.py over the plain
versions of passes/shardbloom.py) against twopaco_tpu/parallel/sharded.py
on the conftest's 8 virtual CPU devices: owner bucketing (send buffers
byte-equal to _bucket's, the probe slots equal to its un-permutation),
the sharded fill (every filter shard equal) and mark (masks, counts and
overflows equal), and ShardedConfig's refusals. Integer data: every
comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.io import windows as jwindows
from twopaco_tpu.parallel import sharded as jsh
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import kernels as jk
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.ops import bloom, pack
from twopaco_tpu_torch.parallel import sharded
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.passes import shardbloom
from twopaco_tpu_torch.passes.pipeline import PassConfig, PipelineConfig

K, P = 9, 128
FULL = (0, 0xFFFFFFFF)


def _batches(B, seed=42, n=4, length=700):
    """Window batches of B rows of related genomes (numpy seed)."""
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    seqs = [(0, jdna.encode(base))] + [
        (i, jdna.encode(oracle.mutate_sequence(rng, base, 0.05, 0.1))) for i in range(1, n)
    ]
    wcfg = jwindows.WindowConfig(k=K, positions_per_row=P, rows_per_batch=B)
    return list(jwindows.iter_window_batches(iter(seqs), wcfg))


def _upload(codes, valid):
    p, m = pack.pack_codes_host(np.asarray(codes))
    return tuple(torch.from_numpy(a) for a in (p, m, np.asarray(valid)))


def _u64(t):
    return t.numpy().view(np.uint64)


def _configs(f, q, layout, B, D):
    jcfg = jk.PassConfig(k=K, q=q, f=f, layout=layout, positions_per_row=P, rows_per_batch=B)
    tcfg = PassConfig(k=K, q=q, f=f, layout=layout, positions_per_row=P, rows_per_batch=B)
    return jsh.ShardedConfig(base=jcfg, n_devices=D), sharded.ShardedConfig(base=tcfg, n_shards=D)


def test_bucket_routing_and_overflow():
    """tests/test_sharded.py:90's case: the send slots, the overflow and
    the probe slots of the port's bucketing equal _bucket's."""
    jcfg = jk.PassConfig(k=5, q=2, f=8, layout="byte")
    scfg = jsh.ShardedConfig(base=jcfg, n_devices=4)
    idx = np.array([0, 1, 64, 65, 66, 200, 255, 100, 130], np.uint64)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 1], bool)
    want, route, over = jsh._bucket(jnp.asarray(idx), jnp.asarray(valid), scfg, cap=2)
    got, slots, tover = shardbloom.bucket_indices_plain(
        torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(valid), 4, 2)
    np.testing.assert_array_equal(_u64(got), np.asarray(want))
    assert int(tover) == int(over) == 1
    np.testing.assert_array_equal(_u64(got)[0], [0, 64 // 4])
    np.testing.assert_array_equal(_u64(got)[3], [255 // 4, np.uint64(2**64 - 1)])
    # every probe's hit comes back as _unbucket's does
    back = np.random.default_rng(0).integers(0, 2, size=(4, 2)).astype(bool)
    un = np.asarray(jsh._unbucket(jnp.asarray(back), route, len(idx)))
    s = slots.numpy()
    np.testing.assert_array_equal(np.where(s >= 0, back.reshape(-1)[np.maximum(s, 0)], False), un)


@pytest.mark.parametrize("D,cap", [(1, 1 << 31), (4, 1 << 29), (3, 715_827_883)])
def test_bucket_refuses_send_slots_past_int32(D, cap):
    """A send slot owner * cap + rank must fit the int32 probe slots: past
    2^31 the plain version would read a sent probe as unsent, so it
    refuses (before allocating the send slots), as the kernel path does."""
    idx = torch.arange(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 probe slots"):
        shardbloom.bucket_indices_plain(idx, torch.ones(8, dtype=torch.bool), D, cap)


@pytest.mark.parametrize("D,f,cap_scale", [(3, 18, 1.0), (8, 18, 1.0), (8, 40, 1.0), (4, 18, 0.05)])
@pytest.mark.parametrize("mode", ["fill", "mark"])
def test_bucket_matches_jax(D, f, cap_scale, mode):
    """The fill and mark indices of a shard's rows bucketed by owner: send
    buffers byte-equal to _bucket's of kernels.fill_indices /
    mark_indices, 64-bit indices at f=40, a cap that overflows."""
    wover = _bucket_vs_jax(D, f, 3, 2 * D, cap_scale, mode, _batches(2 * D)[0])
    assert (wover > 0) == (cap_scale < 1)


def _bucket_vs_jax(D, f, q, B, cap_scale, mode, b):
    """bucket_fill / bucket_mark of batch b's first B/D rows against
    _bucket over kernels.fill_indices / mark_indices (the bit layout):
    send buffers byte-equal, overflow equal. -> the overflow."""
    jscfg, tscfg = _configs(f, q, "bit", B, D)
    rows = slice(0, B // D)
    codes, valid = jnp.asarray(b.codes[rows]), jnp.asarray(b.valid[rows])
    edges = 4 if mode == "fill" else 8
    n = (B // D) * P * edges * q
    cap = max(1, int(tscfg.cap(n) * cap_scale))
    if mode == "fill":
        idx, val = jk.fill_indices(codes, valid, *FULL, jscfg.base)
    else:
        idx, base, _p, _n = jk.mark_indices(codes, valid, *FULL, jscfg.base)
        val = jnp.broadcast_to(base[:, :, None, None], idx.shape)
    want, _route, wover = jsh._bucket(idx.astype(jnp.uint64).reshape(-1), val.reshape(-1),
                                      jscfg, cap)
    fn = shardbloom.bucket_fill if mode == "fill" else shardbloom.bucket_mark
    got = fn(*_upload(b.codes[rows], b.valid[rows]), *FULL, cfg=tscfg.base, n_shards=D, cap=cap)
    np.testing.assert_array_equal(_u64(got[0]), np.asarray(want))
    assert int(got[-1]) == int(wover)
    assert int((got[0] != shardbloom.SENT).sum()) + int(wover) == int(np.asarray(val).sum())
    return int(wover)


def test_mark_probe_slots_match_unbucket():
    """bucket_mark's probe slots, (8q, B*P) edge-hash major: each of a
    shard's real mark probes reads its hit back as _unbucket returns it,
    under a cap that leaves some probes unsent."""
    D, q, B = 4, 2, 8
    jscfg, tscfg = _configs(18, q, "byte", B, D)
    b = _batches(B)[0]
    rows = slice(0, B // D)
    idx, base, _p, _n = jk.mark_indices(jnp.asarray(b.codes[rows]), jnp.asarray(b.valid[rows]),
                                        *FULL, jscfg.base)
    val = jnp.broadcast_to(base[:, :, None, None], idx.shape)
    cap = tscfg.cap(idx.size) // 3
    _want, route, wover = jsh._bucket(idx.astype(jnp.uint64).reshape(-1), val.reshape(-1),
                                      jscfg, cap)
    _send, slots, over = shardbloom.bucket_mark(*_upload(b.codes[rows], b.valid[rows]), *FULL,
                                                cfg=tscfg.base, n_shards=D, cap=cap)
    assert slots.shape == (8 * q, (B // D) * P)
    assert int(over) == int(wover) > 0
    back = np.random.default_rng(1).integers(0, 2, size=(D, cap)).astype(bool)
    un = np.asarray(jsh._unbucket(jnp.asarray(back), route, idx.size))
    s = slots.numpy()
    got = np.where(s >= 0, back.reshape(-1)[np.maximum(s, 0)], False)
    np.testing.assert_array_equal(got.T.reshape(-1), un)


def _run_both(D, layout, f, q, rounds_gate=FULL, B=None):
    """The JAX sharded fill + mark over make_mesh(D) and the port's over a
    LocalMesh of D CPU shards, on the same batches."""
    B = B or D
    jscfg, tscfg = _configs(f, q, layout, B, D)
    jmesh = jsh.make_mesh(D)
    mesh = LocalMesh(["cpu"] * D)
    batches = _batches(B, n=3, length=600)
    jfill, jmark = jsh.sharded_fill_step(jmesh, jscfg), jsh.sharded_mark_step(jmesh, jscfg)
    tfill, tmark = sharded.sharded_fill_step(mesh, tscfg), sharded.sharded_mark_step(mesh, tscfg)
    low, high = rounds_gate
    jfilt = jsh.make_sharded_filter(jmesh, jscfg)
    tfilt = sharded.make_sharded_filter(mesh, tscfg)
    over = None
    for b in batches:
        jfilt, jover = jfill(jfilt, jnp.asarray(b.codes), jnp.asarray(b.valid), jnp.uint32(low),
                             jnp.uint32(high))
        assert int(jover) == 0
        parts = [mesh.put_rows(a) for a in (*pack.pack_codes_host(b.codes), b.valid)]
        over = tfill(tfilt, {s: tuple(x[s] for x in parts) for s in mesh.shards}, low, high, over)
    assert int(mesh.all_gather(over).sum()) == 0
    got_filt = torch.cat([tfilt[s] for s in mesh.shards])
    if layout == "bit":
        got_filt = got_filt.view(torch.int32)
    np.testing.assert_array_equal(got_filt.numpy(), np.asarray(jfilt).view(got_filt.numpy().dtype))
    out = []
    for b in batches:
        jm, jc, jo = jmark(jfilt, jnp.asarray(b.codes), jnp.asarray(b.valid), jnp.uint32(low),
                           jnp.uint32(high))
        parts = [mesh.put_rows(a) for a in (*pack.pack_codes_host(b.codes), b.valid)]
        tm, tc, to = tmark(tfilt, {s: tuple(x[s] for x in parts) for s in mesh.shards}, low, high)
        np.testing.assert_array_equal(torch.cat([tm[s] for s in mesh.shards]).numpy(),
                                      np.asarray(jm))
        assert int(mesh.all_gather(tc).sum()) == int(jc)
        assert int(mesh.all_gather(to).sum()) == int(jo) == 0
        out.append(int(jc))
    return out


@pytest.mark.parametrize("D,layout", [(8, "byte"), (8, "bit"), (3, "bit")])
def test_sharded_fill_and_mark_match_jax(D, layout):
    counts = _run_both(D, layout, f=18, q=3, B=6 if D == 3 else 8)
    assert sum(counts) > 0


def test_sharded_round_gate_matches_jax():
    """A sub-interval round: the fill and the mark gate on the vertex hash."""
    _run_both(8, "byte", f=16, q=2, rounds_gate=(1 << 30, 3 << 30))


def test_sharded_config_refusals():
    base = PassConfig(k=K, f=8, layout="byte", positions_per_row=P, rows_per_batch=8)
    sharded.ShardedConfig(base=base, n_shards=8)  # 2^8 = 32 * 8 slots: enough
    with pytest.raises(ValueError, match="cannot be sharded over 16 shards"):
        sharded.ShardedConfig(base=base, n_shards=16)
    with pytest.raises(ValueError, match=r"rows_per_batch \(8\) must be a multiple"):
        sharded.ShardedConfig(base=base, n_shards=3)
    with pytest.raises(ValueError, match="single-chip only; use --tpu-layout bit"):
        sharded.ShardedConfig(
            base=PassConfig(k=K, f=20, layout="block", rows_per_batch=8), n_shards=4)
    # the JAX package refuses the same configurations
    with pytest.raises(ValueError, match="single-chip only"):
        jsh.ShardedConfig(base=jk.PassConfig(k=K, f=20, layout="block", rows_per_batch=8),
                          n_devices=4)
    with pytest.raises(AssertionError):
        jsh.ShardedConfig(base=jk.PassConfig(k=K, f=8, rows_per_batch=8), n_devices=16)


@pytest.mark.parametrize("f,D", [(18, 3), (20, 8), (36, 4), (38, 8)])
def test_sharded_config_sizes_match_jax(f, D):
    """local_slots, caps and the per-shard layout: -f 38 over 8 shards is
    the bit layout (2^35 slots a shard), as JAX's resolve_layout."""
    tcfg = PipelineConfig(k=25, filter_bits=f, rows_per_batch=8 * D)
    jcfg = JaxConfig(k=25, filter_bits=f, rows_per_batch=8 * D)
    layout = tcfg.resolve_layout(shard_devices=D)
    assert layout == jcfg.resolve_layout(shard_devices=D)
    assert layout == ("byte" if (1 << f) // D <= 1 << 30 else "bit")
    js, ts = (jsh.ShardedConfig(base=jcfg.pass_config(shard_devices=D), n_devices=D),
              sharded.ShardedConfig(base=tcfg.pass_config(shard_devices=D), n_shards=D))
    assert ts.local_slots == js.local_slots and ts.local_slots % 32 == 0
    for n in (1000, 2_621_440, 5_242_880):
        assert ts.cap(n) == js.cap(n)
    assert ts.base.layout == js.base.layout
    if f == 38:
        with pytest.raises(ValueError, match="per device"):
            tcfg.resolve_layout()


def test_make_sharded_filter_shapes():
    mesh = LocalMesh(["cpu"] * 3)
    for layout, dtype in (("byte", torch.uint8), ("bit", torch.uint32)):
        scfg = sharded.ShardedConfig(
            base=PassConfig(k=K, f=10, layout=layout, rows_per_batch=6), n_shards=3)
        filt = sharded.make_sharded_filter(mesh, scfg)
        assert scfg.local_slots == 352  # ceil(1024 / 3) = 342, padded to 32
        want = 352 if layout == "byte" else 11
        assert all(t.shape == (want,) and t.dtype == dtype and not t.any()
                   for t in filt.values())
    with pytest.raises(TypeError):
        bloom.make_filter(10, "byte")  # no default device


PROBE_CHUNK = 4096  # received slots a block of bloom_shard.cu's probe


@pytest.mark.parametrize("layout", ["byte", "bit"])
@pytest.mark.parametrize("D,cap", [(3, 2 * PROBE_CHUNK + 5), (7, PROBE_CHUNK + 16)])
def test_probe_local_prefix_rows_match_jax(layout, D, cap):
    """Hand-made received blocks, each row a prefix of sent local slots
    then SENT (empty rows, full rows, counts at a chunk boundary and one
    either side): the plain probe's hits equal _local_probe's, SENT slots
    read 0, in the byte and bit layouts."""
    rng = np.random.default_rng(D * 11 + cap)
    slots = 1 << 16
    counts = [0, cap, PROBE_CHUNK - 1, PROBE_CHUNK, PROBE_CHUNK + 1, int(rng.integers(0, cap))]
    recv = np.full((D, cap), -1, np.int64)
    for d in range(D):
        c = counts[d % len(counts)]
        recv[d, :c] = rng.integers(0, slots, size=c)
    if layout == "byte":
        filt = rng.integers(0, 2, size=slots).astype(np.uint8)
    else:
        filt = rng.integers(0, 1 << 32, size=slots // 32, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jsh._local_probe(jnp.asarray(filt), jnp.asarray(recv.view(np.uint64)),
                                       layout))
    tfilt = torch.from_numpy(filt.view(np.int32)).view(torch.uint32) if layout == "bit" \
        else torch.from_numpy(filt)
    got = shardbloom.probe_local(tfilt, torch.from_numpy(recv), layout)
    assert got.dtype == torch.uint8 and got.shape == (D * cap,)
    np.testing.assert_array_equal(got.numpy().reshape(D, cap), want.astype(np.uint8))
    assert 0 < int(got.sum()) < int((recv != -1).sum())
    assert not got.numpy().reshape(D, cap)[recv == -1].any()


@pytest.mark.parametrize("fn", ["probe_local", "fill_local"])
def test_local_steps_refuse_a_flat_block(fn):
    """probe_local and fill_local take the (D, cap) received block: a flat
    one raises ValueError (on the CPU as on the card)."""
    filt = bloom.make_filter(10, "byte", "cpu")
    recv = torch.full((3, 8), -1, dtype=torch.int64)
    recv[0, :2] = torch.tensor([5, 9])
    getattr(shardbloom, fn)(filt, recv, "byte")
    with pytest.raises(ValueError, match=r"\(D, cap\) block"):
        getattr(shardbloom, fn)(filt, recv.reshape(-1), "byte")


@pytest.mark.parametrize("f,layout", [(18, "byte"), (36, "bit")])
@pytest.mark.parametrize("mode", ["fill", "mark"])
def test_bucket_gated_rows_match_jax(f, layout, mode):
    """bucket_fill_plain and bucket_mark_plain on a batch with valid-0 and
    short rows under a narrow round gate: send buffers byte-equal to
    _bucket's over kernels.fill_indices / mark_indices, overflow equal."""
    D, q, B = 4, 3, 16
    jscfg, tscfg = _configs(f, q, layout, B, D)
    b = _batches(B, seed=7)[0]
    rows = slice(0, B // D)
    codes = b.codes[rows]
    valid = np.array(b.valid[rows], np.int32)
    valid[0] = 0
    valid[2] = 37
    low, high = 1 << 30, 3 << 30
    if mode == "fill":
        idx, val = jk.fill_indices(jnp.asarray(codes), jnp.asarray(valid), low, high, jscfg.base)
    else:
        idx, base, _p, _n = jk.mark_indices(jnp.asarray(codes), jnp.asarray(valid), low, high,
                                            jscfg.base)
        val = jnp.broadcast_to(base[:, :, None, None], idx.shape)
    cap = tscfg.fill_cap if mode == "fill" else tscfg.mark_cap
    want, _route, wover = jsh._bucket(idx.astype(jnp.uint64).reshape(-1), val.reshape(-1),
                                      jscfg, cap)
    fn = shardbloom.bucket_fill_plain if mode == "fill" else shardbloom.bucket_mark_plain
    got = fn(*_upload(codes, valid), low, high, cfg=tscfg.base, n_shards=D, cap=cap)
    np.testing.assert_array_equal(_u64(got[0]), np.asarray(want))
    assert int(got[-1]) == int(wover) == 0
    sent = int((got[0] != shardbloom.SENT).sum())
    assert 0 < sent == int(np.asarray(val).sum())
    full = fn(*_upload(codes, b.valid[rows]), *FULL, cfg=tscfg.base, n_shards=D, cap=cap)
    assert sent < int((full[0] != shardbloom.SENT).sum())


@pytest.mark.parametrize("q,f,D", [(64, 36, 4), (64, 40, 8), (2000, 36, 4), (5, 30, 4)])
def test_shard_bytes_at_any_q(q, f, D):
    """ShardedConfig.shard_bytes counts the bucketing's scratch at any q:
    a tile shrinks to fewer positions as q grows (down to one) and never
    raises; only the kernel refuses a q whose one position overflows its
    block (2000 at f = 36)."""
    scfg = sharded.ShardedConfig(
        base=PassConfig(k=25, q=q, f=f, layout="bit", positions_per_row=2048,
                        rows_per_batch=64 * D), n_shards=D)
    n_pos = 64 * 2048
    scratch = shardbloom.scratch_bytes(n_pos, D, q, f, marking=True)
    assert scfg.shard_bytes() == (scfg.local_slots // 8 + 4 * n_pos * 8 * q
                                  + 18 * D * scfg.mark_cap + scratch)
    tpos = shardbloom.tile_positions(D, q, f, marking=True)
    assert scratch == -(-n_pos // tpos) * D * 8 + 8
    assert tpos == (8 if q == 64 else 1 if q == 2000 else 256)
    assert shardbloom.tile_fits(D, q, f, marking=True) == (q < 2000)
    assert shardbloom.tile_fits(D, q, f, marking=False)


@pytest.mark.parametrize("mode", ["fill", "mark"])
def test_bucket_many_hashes_match_jax(mode):
    """q = 64 at f = 36 (64-bit indices, 512 mark probes a position: the
    kernel's tile is 8 positions): the port's bucketing equals _bucket's."""
    assert _bucket_vs_jax(4, 36, 64, 8, 1.0, mode, _batches(8, seed=3)[0]) == 0
