"""The distributed step's modules against twopaco_tpu on the CPU (the plain
versions; JAX on the conftest's 8 virtual CPU devices, the port on a
LocalMesh of 8 CPU shards): record routing, the per-record judge and the
whole sharded_sort_step. Integer data: every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.io import windows as jwindows
from twopaco_tpu.parallel import sortshard as jshard
from twopaco_tpu.parallel.sharded import make_mesh
from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.parallel.sortshard import SortShardConfig, sharded_sort_step
from twopaco_tpu_torch.passes import judge, route
from twopaco_tpu_torch.passes.pipeline import PassConfig

D = 8
FULL = (0, 0xFFFFFFFF)


def _batch(k, P, B, seed, n=2, length=900, snp=0.05):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    seqs = [(0, jdna.encode(base))] + [
        (i, jdna.encode(oracle.mutate_sequence(rng, base, snp, 0.1))) for i in range(1, n)
    ]
    wcfg = jwindows.WindowConfig(k=k, positions_per_row=P, rows_per_batch=B)
    return next(jwindows.iter_window_batches(iter(seqs), wcfg))


def _jax_records(b, k, P, B, low=0, high=0xFFFFFFFF):
    cfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    words, payload, pos = jsort.build_sort_records(
        jnp.asarray(b.codes), jnp.asarray(b.valid), (jnp.uint32(0),),
        jnp.uint32(low), jnp.uint32(high), cfg=cfg,
    )
    return cfg, np.asarray(words), np.asarray(payload), np.asarray(pos[0])


def _u32(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)).view(torch.uint32)


def _np(t):
    return pack.as_i64(t).numpy() if t.dtype == torch.uint32 else t.numpy()


@pytest.mark.parametrize("bounds", ["uniform", "measured"])
@pytest.mark.parametrize("cap", [None, 40])
@pytest.mark.parametrize("out", [False, True])
def test_route_records_matches_jax(bounds, cap, out):
    """Send buffers (words, payload, position columns) and the overflow
    count equal _route_records', with a cap that overflows too; out=True
    routes into given send buffers that hold another batch's route."""
    k, P, B = 9, 128, 8
    b = _batch(k, P, B, seed=2024)
    cfg, words, payload, pos = _jax_records(b, k, P, B)
    scfg = jshard.SortShardConfig(base=cfg, n_devices=D)
    cap = cap or scfg.cap()
    bnd = None
    if bounds == "measured":
        w0 = np.sort(words[:, 0][((payload >> 17) & 1) == 1])
        bnd = np.unique(w0[np.linspace(0, len(w0) - 1, D + 1).astype(int)[1:-1]])
        assert len(bnd) == D - 1
    send, over = jshard._route_records(
        jnp.asarray(words), jnp.asarray(payload), (jnp.asarray(pos),), scfg, cap,
        bounds=None if bnd is None else jnp.asarray(bnd),
    )
    send = np.asarray(send)
    bufs = None
    if out:
        bufs = route.new_send(D, cap, words.shape[1], "cpu")
        _cfg, w2, p2, pos2 = _jax_records(_batch(k, P, B, seed=7), k, P, B)
        route.route_records_plain(_u32(w2), _u32(p2), torch.from_numpy(pos2.astype(np.int64)),
                                  D, cap, out=bufs)
    got = route.route_records_plain(
        _u32(words), _u32(payload), torch.from_numpy(pos.astype(np.int64)), D, cap,
        bounds=None if bnd is None else _u32(bnd), out=bufs,
    )
    if out:
        assert all(g is b_ for g, b_ in zip(got, bufs))
    w = words.shape[1]
    np.testing.assert_array_equal(_np(got[0]), send[:, :, :w])
    np.testing.assert_array_equal(_np(got[1]), send[:, :, w])
    np.testing.assert_array_equal(_np(got[2]), send[:, :, w + 1])
    assert int(got[3]) == int(over)
    assert (int(over) > 0) == (cap == 40)


def test_route_overflow_accumulates():
    k, P, B = 9, 128, 8
    _cfg, words, payload, pos = _jax_records(_batch(k, P, B, seed=5), k, P, B)
    args = (_u32(words), _u32(payload), torch.from_numpy(pos.astype(np.int64)), D, 40)
    over = route.route_records_plain(*args)[3]
    once = int(over)
    route.route_records_plain(*args, overflow=over)
    assert once > 0 and int(over) == 2 * once


@pytest.mark.parametrize("abundance", [None, 2, 3])
def test_judge_records_matches_jax(abundance):
    k, P, B = 9, 128, 8
    _cfg, words, payload, pos = _jax_records(_batch(k, P, B, seed=11, n=3), k, P, B)
    sw, spay, _ = jsort.sort_records(
        jnp.asarray(words), jnp.asarray(payload), (jnp.asarray(pos),), w=words.shape[1]
    )
    ab = (1 << 64) - 1 if abundance is None else abundance
    want = jsort.judge_records(sw, spay, jnp.uint64(ab), check_abundance=abundance is not None)
    got = judge.judge_records_plain(_u32(np.asarray(sw)), _u32(np.asarray(spay)), ab)
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert list(got[3:]) == [int(x) for x in want[3:]]
    assert got[4] > 0 or abundance is not None


def _step_pair(b, k, P, B, check_abundance=False, abundance=(1 << 64) - 1):
    cfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    jstep = jshard.sharded_sort_step(make_mesh(D), jshard.SortShardConfig(base=cfg, n_devices=D),
                                     check_abundance=check_abundance)
    want = jstep(jnp.asarray(b.codes), jnp.asarray(b.valid), jnp.uint32(0),
                 jnp.uint32(0xFFFFFFFF), jnp.uint64(abundance))
    mesh = LocalMesh(["cpu"] * D)
    scfg = SortShardConfig(base=PassConfig(k=k, positions_per_row=P, rows_per_batch=B),
                           n_shards=D)
    p, m = pack.pack_codes_host(b.codes)
    parts = [mesh.put_rows(a) for a in (p, m, b.valid)]
    batch = {s: tuple(x[s] for x in parts) for s in mesh.shards}
    got = sharded_sort_step(mesh, scfg, check_abundance)(batch, *FULL, abundance)
    return want, got


def test_sharded_sort_step_matches_jax():
    """Mirrors tests/test_sortshard.py: the port's step against JAX's
    (block by block) and against the single-device sort + judge_records."""
    assert len(jax.devices()) >= D
    k, P, B = 9, 128, 8
    b = _batch(k, P, B, seed=2024)
    (jsw, jpos, jkf, jgids, jnj, jno, jover), (blocks, nj, no, over) = _step_pair(b, k, P, B)
    assert (nj, no, over) == (int(jnj), int(jno), int(jover)) and over == 0
    sw = np.concatenate([_np(blocks[s][0]) for s in range(D)])
    spos = np.concatenate([blocks[s][1].numpy() for s in range(D)])
    kf = np.concatenate([blocks[s][2].numpy() for s in range(D)])
    gids = np.concatenate([blocks[s][3].numpy() for s in range(D)])
    np.testing.assert_array_equal(sw, np.asarray(jsw))
    np.testing.assert_array_equal(kf, np.asarray(jkf))
    jgids, jpos = np.asarray(jgids), np.asarray(jpos)
    assert {(int(p), int(i)) for p, i in zip(spos[gids != 0], gids[gids != 0])} == {
        (int(p), int(i)) for p, i in zip(jpos[jgids != 0], jgids[jgids != 0])
    }
    # the single-device sort + judge_records: the same table and occurrences
    cfg, words, payload, pos = _jax_records(b, k, P, B)
    sw1, pay1, pos1 = jsort.sort_records(
        jnp.asarray(words), jnp.asarray(payload), (jnp.asarray(pos),), w=cfg.w
    )
    kf1, keep1, ids1, _g, nj1, no1 = jsort.judge_records(
        sw1, pay1, jnp.uint64((1 << 64) - 1), check_abundance=False)
    np.testing.assert_array_equal(sw[kf], np.asarray(sw1)[np.asarray(kf1)])
    assert (nj, no) == (int(nj1), int(no1)) and nj > 0
    keep1 = np.asarray(keep1)
    assert {(int(p), int(i)) for p, i in zip(spos[gids != 0], gids[gids != 0])} == {
        (int(p), int(i)) for p, i in zip(np.asarray(pos1[0])[keep1], np.asarray(ids1)[keep1])
    }


def test_sharded_sort_step_abundance_applied():
    """Mirrors tests/test_review_fixes.py:129: four identical sequences,
    every junction occurs a multiple of 4 times; -a 2 drops them all."""
    k, P, B = 7, 64, 8
    rng = np.random.default_rng(3)
    base = oracle.generate_sequence(rng, 60).replace("N", "C")
    wcfg = jwindows.WindowConfig(k=k, positions_per_row=P, rows_per_batch=B)
    b = next(jwindows.iter_window_batches(iter([(i, jdna.encode(base)) for i in range(4)]), wcfg))
    want, (_blocks, nj, no, over) = _step_pair(b, k, P, B, check_abundance=True, abundance=2)
    assert over == 0 and nj == 0 and (nj, no) == (int(want[4]), int(want[5]))
    _want, (_blocks, nj_all, _no, _over) = _step_pair(b, k, P, B)
    assert nj_all > 0


def test_sortshard_config_cap():
    for P, B in ((128, 8), (2048, 256), (16384, 128)):
        for n in (1, 4, 8):
            want = jshard.SortShardConfig(
                base=jkernels.PassConfig(k=25, positions_per_row=P, rows_per_batch=B),
                n_devices=n).cap()
            got = SortShardConfig(base=PassConfig(k=25, positions_per_row=P, rows_per_batch=B),
                                  n_shards=n).cap()
            assert got == want
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        SortShardConfig(base=PassConfig(k=25, positions_per_row=128, rows_per_batch=6),
                        n_shards=4)
