"""The port's Bloom engine modules (plain PyTorch) against the JAX package,
module by module, on the same numpy-seeded inputs: edge hashes and probe
indices, the filter layouts, pass 1 (fill), pass 2 (mark), the candidate
records, verification (the port's sort + judge against verify_records) and
pass 4 (lookup). Integer data: every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu.ops import bloom as jbloom
from twopaco_tpu.ops import buzhash as jbz
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import kernels as jk
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch import dna
from twopaco_tpu_torch.io import windows
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import extract, fill, judge, lookup, mark, sort
from twopaco_tpu_torch.passes.pipeline import PassConfig, PipelineConfig

B, P, F = 4, 256, 20
FULL = (0, 0xFFFFFFFF)
SUB = (1 << 30, 3 << 30)  # a sub-interval round gate
NO_AB = judge.NO_ABUNDANCE


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.cpu().numpy().astype(np.int64)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


# ---- hashes ----------------------------------------------------------


@pytest.mark.parametrize("f", [20, 32, 34])
def test_edge_hashes_and_probe_indices(f):
    rng = np.random.default_rng(f)
    k, q, shape = 25, 5, (3, 200)
    codes = rng.integers(0, 5, size=shape).astype(np.uint8)  # N (4) included
    tabs = [jbz.TABLE_1, jbz.TABLE_2, jbz.TABLE_3, jbz.TABLE_4]
    syms_j, syms_t = {}, {}
    for ti, table in enumerate(tabs):
        hf, hr = _u32(rng, shape), _u32(rng, shape)
        for edge in ("out_edge_sym", "in_edge_sym"):
            for c in [0, 1, 2, 3, "vec"]:
                jc = jnp.asarray(codes) if c == "vec" else c
                tc = torch.from_numpy(codes) if c == "vec" else c
                j = getattr(jbz, edge)(jnp.asarray(hf), jnp.asarray(hr), table, jc, k)
                t = getattr(bz, edge)(
                    torch.from_numpy(hf.astype(np.int64)), torch.from_numpy(hr.astype(np.int64)),
                    table, tc, k,
                )
                assert np.array_equal(_np(j), _t(t)), (edge, c, ti)
                syms_j[(edge, c, ti)], syms_t[(edge, c, ti)] = j, t
    for edge in ("out_edge_sym", "in_edge_sym"):
        e_j = [syms_j[(edge, "vec", ti)] for ti in range(4)]
        e_t = [syms_t[(edge, "vec", ti)] for ti in range(4)]
        extra_j = dict(e3=e_j[2], e4=e_j[3]) if f > 32 else {}
        extra_t = dict(e3=e_t[2], e4=e_t[3]) if f > 32 else {}
        j = jbz.probe_indices_from_sym(e_j[0], e_j[1], q, f, **extra_j)
        t = bz.probe_indices_from_sym(e_t[0], e_t[1], q, f, **extra_t)
        assert t.shape == shape + (q,)
        assert np.array_equal(_np(j), _t(t))
        assert int(t.max()) < (1 << f)


# ---- filter layouts ----------------------------------------------------


@pytest.mark.parametrize("layout", ["byte", "bit"])
def test_bloom_fill_probe(layout):
    rng = np.random.default_rng(11)
    f = 16
    idx = rng.integers(0, 1 << f, size=4096).astype(np.int64)
    valid = rng.random(4096) < 0.7
    jf = jbloom.fill(jbloom.make_filter(f, layout), jnp.asarray(idx.astype(np.uint32)),
                     jnp.asarray(valid), layout)
    tf = bloom.fill(bloom.make_filter(f, layout, "cpu"), torch.from_numpy(idx),
                    torch.from_numpy(valid), layout)
    assert np.array_equal(np.asarray(jf), tf.numpy())
    allidx = np.arange(1 << f)
    hits = bloom.probe(tf, torch.from_numpy(allidx), layout).numpy()
    assert np.array_equal(hits, np.asarray(jbloom.probe(jf, jnp.asarray(allidx), layout)))
    assert hits[idx[valid]].all() and hits.sum() == len(set(idx[valid].tolist()))
    qidx = rng.integers(0, 1 << f, size=(500, 5))
    assert np.array_equal(
        bloom.probe_all(tf, torch.from_numpy(qidx), layout).numpy(),
        np.asarray(jbloom.probe_all(jf, jnp.asarray(qidx), layout)),
    )


def test_bloom_fill_idempotent_and_bit_matches_byte():
    rng = np.random.default_rng(12)
    f = 14
    idx = torch.from_numpy(rng.integers(0, 1 << f, size=3000))
    valid = torch.from_numpy(rng.random(3000) < 0.5)
    fb = bloom.fill(bloom.make_filter(f, "byte", "cpu"), idx, valid, "byte")
    fbit = bloom.fill(bloom.make_filter(f, "bit", "cpu"), idx, valid, "bit")
    again = bloom.fill(fbit.clone(), idx, valid, "bit")
    assert torch.equal(again.view(torch.int32), fbit.view(torch.int32))
    allidx = torch.arange(1 << f)
    assert torch.equal(bloom.probe(fb, allidx, "byte"), bloom.probe(fbit, allidx, "bit"))


def test_bloom_blocks():
    rng = np.random.default_rng(13)
    f, q = 12, 5
    block = rng.integers(0, 1 << (f - 8), size=(64, 5))
    e1, e2 = _u32(rng, (64, 5)), _u32(rng, (64, 5))
    valid = rng.random((64, 5)) < 0.6
    jbits = jbloom.block_bits(jnp.asarray(e1), jnp.asarray(e2), q)
    tbits = bloom.block_bits(torch.from_numpy(e1.astype(np.int64)),
                             torch.from_numpy(e2.astype(np.int64)), q)
    assert np.array_equal(_np(jbits), _t(tbits))
    jf = jbloom.fill_blocks(jbloom.make_filter(f, "block"), jnp.asarray(block.astype(np.int32)),
                            jbits, jnp.asarray(valid))
    tf = bloom.fill_blocks(bloom.make_filter(f, "block", "cpu"), torch.from_numpy(block), tbits,
                           torch.from_numpy(valid))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    pbits = torch.from_numpy(rng.integers(0, 256, size=(64, 8, q)))
    pblock = torch.from_numpy(rng.integers(0, 1 << (f - 8), size=64))
    assert np.array_equal(
        bloom.probe_blocks(tf, pblock, pbits).numpy(),
        np.asarray(jbloom.probe_blocks(jf, jnp.asarray(pblock.numpy().astype(np.int32)),
                                       jnp.asarray(pbits.numpy().astype(np.uint32)))),
    )
    hv = torch.from_numpy(_u32(rng, 100).astype(np.int64))
    assert np.array_equal(
        bloom.block_index(hv, 20).numpy(),
        np.asarray(jbloom.block_index(jnp.asarray(hv.numpy().astype(np.uint32)), 20)),
    )
    with pytest.raises(ValueError, match="f >= 8"):
        bloom.make_filter(7, "block", "cpu")


def _err(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_layout_errors_are_the_jax_messages():
    """The single-device cases of tests/test_review_fixes.py:87-176: the
    port raises the JAX package's messages, word for word."""
    for f in (0, 20, 30, 31, 35):
        assert bloom.choose_layout_slots(1 << f) == jbloom.choose_layout(f)
    assert _err(bloom.choose_layout_slots, 1 << 36) == _err(jbloom.choose_layout, 36)
    assert "dist-bloom" in _err(bloom.choose_layout_slots, 1 << 36)
    for f, layout in ((36, "bit"), (36, "block"), (31, "byte"), (38, "auto")):
        jc = JaxConfig(k=25, filter_bits=f, layout=layout)
        tc = PipelineConfig(k=25, filter_bits=f, layout=layout)
        msg = _err(tc.resolve_layout)
        assert msg == _err(jc.resolve_layout) == _err(tc.pass_config)
        assert "per device" in msg and "dist-bloom" in msg
    for f, layout in ((34, "auto"), (30, "auto"), (20, "block"), (35, "bit")):
        jc = JaxConfig(k=25, filter_bits=f, layout=layout, hash_functions=3)
        tc = PipelineConfig(k=25, filter_bits=f, layout=layout, hash_functions=3)
        assert tc.resolve_layout() == jc.resolve_layout()
        jp, tp = jc.pass_config(), tc.pass_config()
        assert (tp.k, tp.q, tp.f, tp.layout, tp.P, tp.B) == (jp.k, jp.q, jp.f, jp.layout, jp.P, jp.B)


# ---- the passes ------------------------------------------------------


def _batch(k, seed=0):
    """The first (B, P) window batch of four related genomes with N runs:
    -> (codes (B, R) uint8, valid (B,) int32, row0)."""
    rng = np.random.default_rng(seed + k)
    base = oracle.generate_sequence(rng, 700, n_rate=1 / 150)
    seqs = [base] + [oracle.mutate_sequence(rng, base, 0.01, 0.1) for _ in range(3)]
    wcfg = windows.WindowConfig(k=k, positions_per_row=P, rows_per_batch=B)
    b = next(windows.iter_window_batches(
        iter([(i, dna.encode(s)) for i, s in enumerate(seqs)]), wcfg))
    return b.codes, b.valid, b.row0


def _forms(codes, valid):
    p, m = pack.pack_codes_host(codes)
    return (jnp.asarray(p), jnp.asarray(m)), jnp.asarray(valid), [
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(valid)]


def _cfgs(k, layout, f=F):
    return (jk.PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=B),
            PassConfig(k=k, f=f, layout=layout, positions_per_row=P, rows_per_batch=B))


@pytest.mark.parametrize("layout", ["byte", "bit", "block"])
@pytest.mark.parametrize("k", [7, 25, 101])
def test_fill_and_mark(layout, k):
    """pass1_fill's filter and pass2_mark's mask and count, at the full and
    at a sub-interval round gate."""
    codes, valid, _ = _batch(k)
    jcodes, jvalid, targs = _forms(codes, valid)
    jcfg, tcfg = _cfgs(k, layout)
    for low, high in (FULL, SUB):
        jfilt = jk.pass1_fill(jbloom.make_filter(F, layout), jcodes, jvalid,
                              jnp.uint32(low), jnp.uint32(high), cfg=jcfg)
        tfilt = fill.bloom_fill(bloom.make_filter(F, layout, "cpu"), *targs, low, high, cfg=tcfg)
        assert np.array_equal(np.asarray(jfilt), tfilt.numpy())
        assert int(np.asarray(jfilt).astype(bool).sum()) > 0
        jmask, jcount = jk.pass2_mark(jfilt, jcodes, jvalid, jnp.uint32(low),
                                      jnp.uint32(high), cfg=jcfg)
        tmask, tcount = mark.bloom_mark(tfilt, *targs, low, high, cfg=tcfg)
        assert tmask.dtype == torch.uint8 and tmask.shape == (B, P // 8)
        assert np.array_equal(np.asarray(jmask), tmask.numpy())
        assert int(jcount) == int(tcount) > 0


def test_pack_mask_round_trip():
    rng = np.random.default_rng(4)
    m = rng.random((3, 64)) < 0.3
    tp = mark.pack_mask(torch.from_numpy(m))
    assert np.array_equal(tp.numpy(), np.asarray(jk.pack_mask(jnp.asarray(m))))
    assert np.array_equal(tp.numpy(), np.packbits(m, axis=1))
    assert np.array_equal(mark.unpack_mask(tp, 64).numpy(), m)


def _marked(k, layout="byte", seed=0):
    codes, valid, row0 = _batch(k, seed)
    jcodes, jvalid, targs = _forms(codes, valid)
    jcfg, tcfg = _cfgs(k, layout)
    filt = fill.bloom_fill(bloom.make_filter(F, layout, "cpu"), *targs, *FULL, cfg=tcfg)
    tmask, tcount = mark.bloom_mark(filt, *targs, *FULL, cfg=tcfg)
    return jcodes, jvalid, targs, jcfg, tmask, int(tcount), row0


def _extract(targs, tmask, count, k, pos_base=0, slots=None):
    buf, state = extract.new_buffer(count if slots is None else slots, pack.n_words(k), "cpu")
    return extract.extract_records(targs[0], targs[1], tmask, buf, state, pos_base, k=k, P=P)


@pytest.mark.parametrize("k", [7, 25, 101])
def test_extract_records(k):
    jcodes, _jvalid, targs, jcfg, tmask, count, _ = _marked(k)
    jw, jin, jout, jcount = jk.extract_records(jcodes, jnp.asarray(tmask.numpy()), cfg=jcfg,
                                               cap=B * P)
    assert int(jcount) == count
    (tw, tpay, tpos), state = _extract(targs, tmask, count, k, pos_base=1000)
    assert state.tolist() == [count, 0]
    assert np.array_equal(_np(jw)[:count], _t(pack.as_i64(tw)))
    pay = _t(pack.as_i64(tpay))
    assert np.array_equal(_np(jin)[:count], pay & 0xFF)
    assert np.array_equal(_np(jout)[:count], (pay >> 8) & 0xFF)
    assert ((pay >> 17) & 1).all()
    flat = np.flatnonzero(np.unpackbits(tmask.numpy(), axis=1).reshape(-1))
    assert np.array_equal(tpos.numpy(), 1000 + flat)


def test_extract_appends_and_flags_overflow():
    k = 25
    _jc, _jv, targs, _jcfg, tmask, count, _ = _marked(k)
    buf, state = extract.new_buffer(2 * count - 3, pack.n_words(k), "cpu")
    for base in (0, B * P):
        extract.extract_records(targs[0], targs[1], tmask, buf, state, base, k=k, P=P)
    assert state.tolist() == [2 * count, 1]
    (one_w, _p, one_pos), _s = _extract(targs, tmask, count, k)
    assert torch.equal(buf[0][count:].view(torch.int32), one_w[:count - 3].view(torch.int32))
    assert torch.equal(buf[2][count:], B * P + one_pos[:count - 3])


def _round_records(k, seeds=(0, 1, 2)):
    """Candidate records of three batches, one buffer: JAX's concatenated
    extract rows and the port's buffer."""
    jrows, parts = [], []
    for s in seeds:
        jcodes, _jv, targs, jcfg, tmask, count, _ = _marked(k, seed=s)
        jw, jin, jout, _c = jk.extract_records(jcodes, jnp.asarray(tmask.numpy()), cfg=jcfg,
                                               cap=B * P)
        jrows.append((np.asarray(jw)[:count], np.asarray(jin)[:count],
                      np.asarray(jout)[:count]))
        parts.append((targs, tmask, count))
    total = sum(c for _t, _m, c in parts)
    buf, state = extract.new_buffer(total, pack.n_words(k), "cpu")
    for i, (targs, tmask, _c) in enumerate(parts):
        extract.extract_records(targs[0], targs[1], tmask, buf, state, i * B * P, k=k, P=P)
    return [np.concatenate(c) for c in zip(*jrows)], buf


@pytest.mark.parametrize("k", [7, 25])
@pytest.mark.parametrize("abundance", [NO_AB, 2])
def test_sort_judge_equals_verify_records(k, abundance):
    (jw, jin, jout), buf = _round_records(k)
    m, w = jw.shape
    m_pad = 1 << max(10, (m - 1).bit_length())  # the JAX engine's padding
    words = np.full((m_pad, w), 0xFFFFFFFF, np.uint32)
    in_c, out_c = np.zeros(m_pad, np.uint8), np.zeros(m_pad, np.uint8)
    words[:m], in_c[:m], out_c[:m] = jw, jin, jout
    sw, keep_first, n_groups, n_junc = jk.verify_records(
        jnp.asarray(words), jnp.asarray(in_c), jnp.asarray(out_c), jnp.uint64(abundance), w=w)
    want = np.asarray(sw)[np.asarray(keep_first)]
    table, _pos, _ids, t_groups, t_junc, _n_occ = judge.judge_compact(
        *sort.sort_records(*buf, key_bits=2 * k), abundance)
    assert (t_groups, t_junc) == (int(n_groups), int(n_junc))
    assert np.array_equal(_t(pack.as_i64(table)), want.astype(np.int64))
    assert t_junc > 0 if abundance == NO_AB else t_junc < m


@pytest.mark.parametrize("k", [7, 25, 101])
def test_pass4_lookup(k):
    jcodes, jvalid, targs, jcfg, tmask, count, _ = _marked(k)
    buf, _state = _extract(targs, tmask, count, k)
    table = judge.judge_compact(*sort.sort_records(*buf, key_bits=2 * k))[0]
    assert table.shape[0] > 0
    jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(tmask.numpy()), jvalid,
                                       jnp.asarray(table.numpy()), cfg=jcfg, cap=count)
    tpos, tids, tcnt = lookup.pass4_lookup(*targs, tmask, table, count, k=k, P=P)
    n = int(jcnt)
    assert int(tcnt) == n > 0
    assert np.array_equal(np.asarray(jpos)[:n], tpos.numpy()[:n])
    assert np.array_equal(np.asarray(jids)[:n], tids.numpy()[:n])
    assert (tpos.numpy()[n:] == B * P).all() and (tids.numpy()[n:] == lookup.INVALID_ID32).all()
    # a table of every other junction: the misses drop out, ranks shift
    half = table[::2].contiguous()
    jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(tmask.numpy()), jvalid,
                                       jnp.asarray(half.numpy()), cfg=jcfg, cap=count)
    tpos, tids, tcnt = lookup.pass4_lookup(*targs, tmask, half, count, k=k, P=P)
    n = int(jcnt)
    assert int(tcnt) == n and np.array_equal(np.asarray(jids)[:n], tids.numpy()[:n])
    assert np.array_equal(np.asarray(jpos)[:n], tpos.numpy()[:n])


def test_pass4_lookup_empty_table():
    k = 25
    jcodes, jvalid, targs, jcfg, tmask, count, _ = _marked(k)
    empty = torch.empty((0, pack.n_words(k)), dtype=torch.uint32)
    jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(tmask.numpy()), jvalid,
                                       jnp.zeros((0, pack.n_words(k)), jnp.uint32),
                                       cfg=jcfg, cap=count)
    tpos, tids, tcnt = lookup.pass4_lookup(*targs, tmask, empty, count, k=k, P=P)
    assert int(jcnt) == int(tcnt) == 0
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert np.array_equal(np.asarray(jids), tids.numpy())
