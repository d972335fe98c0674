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


def _decode(keys, id_bits):
    """-> (positions, signed ids) int64 of the lookup's int64-held u64 keys."""
    u = keys.cpu().numpy().view(np.uint64)
    pos = (u >> np.uint64(id_bits)).astype(np.int64)
    return pos, (u & np.uint64((1 << id_bits) - 1)).astype(np.int64) - (1 << (id_bits - 1))


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


def _uneven_batches(k, seed, rows=(4, 2, 4, 1)):
    """A round's table of uneven batches: rows of related genome windows
    with N runs (1 to k + 3 chars), each batch with its own row count and
    valid counts (a full row, a row with valid 0, short ones). -> [(codes
    (B_b, R) uint8, valid (B_b,) int32)]."""
    rng = np.random.default_rng(seed * 1000 + k)
    R = P + k + 1
    base = rng.integers(0, 4, size=2 * R).astype(np.uint8)
    out = []
    for b, nr in enumerate(rows):
        codes = np.stack([base[s : s + R] for s in rng.integers(0, R, size=nr)])
        flip = rng.random(codes.shape) < 0.02
        codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
        for r in range(nr):
            for _ in range(3):
                s = int(rng.integers(0, R))
                codes[r, s : s + int(rng.integers(1, k + 4))] = 4
        valid = rng.integers(0, P + 1, size=nr).astype(np.int32)
        valid[0] = P
        if b == 0:
            valid[1] = 0
        out.append((codes, valid))
    return out


@pytest.mark.parametrize("layout,f", [("byte", F), ("bit", 34), ("block", F)])
@pytest.mark.parametrize("k", [7, 25, 101])
def test_fill_mark_batches_match_jax(layout, f, k):
    """bloom_fill_batches and bloom_mark_batches (their plain versions on
    the CPU) equal pass1_fill and pass2_mark applied batch by batch, over a
    table of uneven batches (row counts 4, 2, 4, 1; a row with valid 0,
    short valid counts, N runs), at the full and at a sub-interval gate:
    the filter (f = 34: 64-bit indices) and every mask and count exact."""
    batches = _uneven_batches(k, seed=len(layout))
    uploads = [_forms(c, v)[2] for c, v in batches]
    # JAX takes each batch padded to B rows of valid 0 (one compile): a row
    # of valid 0 inserts and marks nothing
    jforms = [_forms(np.pad(c, ((0, B - len(c)), (0, 0))), np.pad(v, (0, B - len(v))))[:2]
              for c, v in batches]
    jcfg, tcfg = _cfgs(k, layout, f)
    for low, high in (FULL, SUB):
        jfilt = jbloom.make_filter(f, layout)
        for jcodes, jvalid in jforms:
            jfilt = jk.pass1_fill(jfilt, jcodes, jvalid, jnp.uint32(low), jnp.uint32(high),
                                  cfg=jcfg)
        tfilt = fill.bloom_fill_batches(bloom.make_filter(f, layout, "cpu"), uploads, low,
                                        high, cfg=tcfg)
        jview = torch.from_numpy(np.asarray(jfilt).view(np.int8))
        assert torch.equal(tfilt.view(torch.int8), jview) and bool(jview.any())
        del jview
        masks, counts = mark.bloom_mark_batches(tfilt, uploads, low, high, cfg=tcfg)
        del tfilt
        assert counts.dtype == torch.int64 and counts.shape == (len(batches),)
        for (jcodes, jvalid), m, c in zip(jforms, masks, counts):
            jmask, jcount = jk.pass2_mark(jfilt, jcodes, jvalid, jnp.uint32(low),
                                          jnp.uint32(high), cfg=jcfg)
            assert m.shape == (len(m), P // 8)
            assert np.array_equal(np.asarray(jmask)[: len(m)], m.numpy())
            assert not np.asarray(jmask)[len(m) :].any() and int(jcount) == int(c)
        assert int(counts.sum()) > 0
        del jfilt


def _probe_order(slot_hits, prev, nxt, base):
    """A model of bloom_mark.cu's probe order: a position in the round whose
    prev or next is N is a candidate with no read; else slot 0 of the six
    edges c·V (c != prev) and V·c (c != next) is read, together, then slot
    1 of the edges whose slot 0 is set, together, and so on; the position is
    a candidate when an edge has all q slots set. slot_hits (n, 8, q) bool:
    what each slot would read. -> (candidates (n,) bool, reads (n, q): the
    slots read at each step)."""
    n, _e, q = slot_hits.shape
    cand, reads = np.zeros(n, bool), np.zeros((n, q), np.int64)
    for t in range(n):
        if not base[t]:
            continue
        if prev[t] >= 4 or nxt[t] >= 4:
            cand[t] = True
            continue
        alive = [c for c in range(4) if c != prev[t]] + [4 + c for c in range(4) if c != nxt[t]]
        for j in range(q):
            reads[t, j] = len(alive)
            alive = [e for e in alive if slot_hits[t, e, j]]
        cand[t] = bool(alive)
    return cand, reads


@pytest.mark.parametrize("density", [0.2, 0.7, 0.95])
@pytest.mark.parametrize("q", [1, 5])
def test_probe_order_matches_mark_decide(density, q):
    """The kernel's probe order decides as mark_decide does on the hits of
    every edge; it reads slot 0 of six edges a definite position, and slot
    j of an edge only when its slots 0 .. j-1 are set."""
    rng = np.random.default_rng(int(density * 100) + q)
    n = 4000
    slot_hits = rng.random((n, 8, q)) < density
    prev, nxt = rng.integers(0, 5, size=n), rng.integers(0, 5, size=n)
    base = rng.random(n) < 0.9
    cand, reads = _probe_order(slot_hits, prev, nxt, base)
    want = mark.mark_decide(torch.from_numpy(slot_hits.all(-1))[None],
                            torch.from_numpy(base)[None], torch.from_numpy(prev)[None],
                            torch.from_numpy(nxt)[None])[0].numpy()
    assert np.array_equal(cand, want) and cand.any()
    definite = base & (prev < 4) & (nxt < 4)
    assert (reads[definite, 0] == 6).all() and (reads[~definite] == 0).all()
    # slot j is read for the definite positions' edges with slots 0 .. j-1 set
    own = np.zeros((n, 8), bool)
    own[np.arange(n), prev.clip(max=3)] = True
    own[np.arange(n), 4 + nxt.clip(max=3)] = True
    for j in range(1, q):
        set_before = (slot_hits[:, :, :j].all(-1) & ~own).sum(1)
        assert np.array_equal(reads[definite, j], set_before[definite])


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


@pytest.mark.parametrize("k", [7, 25, 101])
@pytest.mark.parametrize("short", [0, 4])  # 4: the buffer overflows
def test_extract_records_batches_match_jax(k, short):
    """extract_records_batches (its plain version on the CPU) over a table
    of uneven batches (row counts 4, 2, 4, 1; N runs, short and zero valid
    counts) at ascending bases with a gap, appended after records already
    in the buffer, equals JAX's extract_records applied batch by batch:
    the canonical words, in/out extensions and positions in order; a
    buffer short of the count keeps the first records and sets the
    overflow flag."""
    batches = _uneven_batches(k, seed=5)
    uploads = [_forms(c, v)[2] for c, v in batches]
    jforms = [_forms(np.pad(c, ((0, B - len(c)), (0, 0))), np.pad(v, (0, B - len(v))))[:2]
              for c, v in batches]
    jcfg, tcfg = _cfgs(k, "byte")
    filt = fill.bloom_fill_batches(bloom.make_filter(F, "byte", "cpu"), uploads, *FULL, cfg=tcfg)
    masks, counts = mark.bloom_mark_batches(filt, uploads, *FULL, cfg=tcfg)
    bases = [0, 4 * P, 9 * P, 13 * P]  # a gap after the second batch
    want_w, want_in, want_out, want_pos = [], [], [], []
    for (jcodes, _jv), m, base in zip(jforms, masks, bases):
        jmask = np.pad(m.numpy(), ((0, B - len(m)), (0, 0)))
        jw, jin, jout, jcount = jk.extract_records(jcodes, jnp.asarray(jmask), cfg=jcfg,
                                                   cap=B * P)
        c = int(jcount)
        want_w.append(_np(jw)[:c])
        want_in.append(_np(jin)[:c])
        want_out.append(_np(jout)[:c])
        want_pos.append(base + np.flatnonzero(np.unpackbits(jmask, axis=1).reshape(-1)))
    want_w, want_in, want_out, want_pos = (np.concatenate(x) for x in
                                           (want_w, want_in, want_out, want_pos))
    n = len(want_pos)
    assert n == int(counts.sum()) > 0
    pre = 3  # records appended before the call
    buf, state = extract.new_buffer(pre + n - short, pack.n_words(k), "cpu")
    state[0] = pre
    (tw, tpay, tpos), state = extract.extract_records_batches(uploads, masks, buf, state, bases,
                                                              k=k, P=P)
    assert state.tolist() == [pre + n, int(short > 0)]
    m = n - short
    assert np.array_equal(_t(pack.as_i64(tw))[pre:], want_w[:m])
    pay = _t(pack.as_i64(tpay))[pre:]
    assert np.array_equal(pay & 0xFF, want_in[:m])
    assert np.array_equal((pay >> 8) & 0xFF, want_out[:m])
    assert ((pay >> 17) & 1).all()
    assert np.array_equal(tpos.numpy()[pre:], want_pos[:m])
    with pytest.raises(ValueError, match="batches"):
        extract.extract_records_batches(uploads, masks[:-1], buf, state, bases, k=k, P=P)


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
    """pass4_lookup's keys decode to JAX's pass4_lookup positions and ids
    (at 32 and 20 id bits), the unused slots PAD_KEY; pass4_lookup_plain
    is JAX's function, padding included."""
    jcodes, jvalid, targs, jcfg, tmask, count, _ = _marked(k)
    buf, _state = _extract(targs, tmask, count, k)
    table = judge.judge_compact(*sort.sort_records(*buf, key_bits=2 * k))[0]
    assert table.shape[0] > 0
    # a table of every other junction: the misses drop out, ranks shift
    for tab in (table, table[::2].contiguous()):
        jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(tmask.numpy()), jvalid,
                                           jnp.asarray(tab.numpy()), cfg=jcfg, cap=count)
        n = int(jcnt)
        assert n > 0
        for id_bits in (32, 20):
            keys, tcnt = lookup.pass4_lookup(*targs, tmask, tab, count, k=k, P=P,
                                             id_bits=id_bits)
            assert keys.dtype == torch.int64 and int(tcnt) == n
            pos, ids = _decode(keys[:n], id_bits)
            assert np.array_equal(_np(jpos)[:n], pos) and np.array_equal(_np(jids)[:n], ids)
            assert (keys.numpy()[n:] == lookup.PAD_KEY).all()
        ppos, pids, pcnt = lookup.pass4_lookup_plain(*targs, tmask, tab, count, k=k, P=P)
        assert int(pcnt) == n
        assert np.array_equal(np.asarray(jpos), ppos.numpy())
        assert np.array_equal(np.asarray(jids), pids.numpy())


def test_pass4_lookup_empty_table():
    k = 25
    jcodes, jvalid, targs, jcfg, tmask, count, _ = _marked(k)
    empty = torch.empty((0, pack.n_words(k)), dtype=torch.uint32)
    jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(tmask.numpy()), jvalid,
                                       jnp.zeros((0, pack.n_words(k)), jnp.uint32),
                                       cfg=jcfg, cap=count)
    keys, tcnt = lookup.pass4_lookup(*targs, tmask, empty, count, k=k, P=P, id_bits=32)
    assert int(jcnt) == int(tcnt) == 0
    assert keys.shape == (count,) and (keys.numpy() == lookup.PAD_KEY).all()
    ppos, pids, _c = lookup.pass4_lookup_plain(*targs, tmask, empty, count, k=k, P=P)
    assert np.array_equal(np.asarray(jpos), ppos.numpy())
    assert np.array_equal(np.asarray(jids), pids.numpy())


@pytest.mark.parametrize("k", [7, 25, 101])
@pytest.mark.parametrize("table_kind", ["all", "half"])
def test_pass4_lookup_batches(k, table_kind):
    """pass4_lookup_batches (its plain version on the CPU) over a table of
    uneven batches at ascending bases with a gap equals JAX's pass4_lookup
    applied batch by batch, each batch's hits offset by its base and
    concatenated: the keys (at 32 and 20 id bits) ascending and decoding
    to those positions and ids, the count exact, the unused slots PAD_KEY;
    a cap below the count keeps the first hits and counts them all; ids or
    positions past the key layout raise."""
    batches = _uneven_batches(k, seed=11)
    uploads = [_forms(c, v)[2] for c, v in batches]
    jforms = [_forms(np.pad(c, ((0, B - len(c)), (0, 0))), np.pad(v, (0, B - len(v))))[:2]
              for c, v in batches]
    jcfg, tcfg = _cfgs(k, "byte")
    filt = fill.bloom_fill_batches(bloom.make_filter(F, "byte", "cpu"), uploads, *FULL, cfg=tcfg)
    masks, counts = mark.bloom_mark_batches(filt, uploads, *FULL, cfg=tcfg)
    n_cand = int(counts.sum())
    buf, state = extract.new_buffer(n_cand, pack.n_words(k), "cpu")
    for i, (up, m) in enumerate(zip(uploads, masks)):
        extract.extract_records(up[0], up[1], m, buf, state, i * B * P, k=k, P=P)
    table = judge.judge_compact(*sort.sort_records(*buf, key_bits=2 * k))[0]
    table = table if table_kind == "all" else table[::2].contiguous()
    bases = [0, 4 * P, 9 * P, 13 * P]  # a gap after the second batch
    want_pos, want_ids = [], []
    for (jcodes, jvalid), m, base in zip(jforms, masks, bases):
        jmask = np.pad(m.numpy(), ((0, B - len(m)), (0, 0)))
        jpos, jids, jcnt = jk.pass4_lookup(jcodes, jnp.asarray(jmask), jvalid,
                                           jnp.asarray(table.numpy()), cfg=jcfg, cap=B * P)
        want_pos.append(np.asarray(jpos)[: int(jcnt)].astype(np.int64) + base)
        want_ids.append(np.asarray(jids)[: int(jcnt)])
    want_pos, want_ids = np.concatenate(want_pos), np.concatenate(want_ids)
    n = len(want_pos)
    assert n > 0 and np.all(np.diff(want_pos) > 0)
    for id_bits in (32, 20):
        for cap in (n_cand, n // 2):
            keys, cnt = lookup.pass4_lookup_batches(uploads, masks, table, cap, bases, k=k, P=P,
                                                    id_bits=id_bits)
            assert keys.dtype == torch.int64 and keys.shape == (cap,) and int(cnt) == n
            m = min(n, cap)
            pos, ids = _decode(keys[:m], id_bits)
            assert np.array_equal(pos, want_pos[:m]) and np.array_equal(ids, want_ids[:m])
            assert np.all(np.diff(keys.numpy()[:m].view(np.uint64)) > 0)
            assert (keys.numpy()[m:] == lookup.PAD_KEY).all()
    pad = bases[-1] + len(batches[-1][0]) * P
    too_few = 65 - pad.bit_length()  # the positions need one more bit
    with pytest.raises(ValueError, match="do not fit a key"):
        lookup.pass4_lookup_batches(uploads, masks, table, n_cand, bases, k=k, P=P,
                                    id_bits=too_few)
    if len(table) >= 2:  # the ids need one more bit
        with pytest.raises(ValueError, match="do not fit a key"):
            lookup.pass4_lookup_batches(uploads, masks, table, n_cand, bases, k=k, P=P,
                                        id_bits=len(table).bit_length())


@pytest.mark.parametrize("spill", [False, True])
def test_mask_store_group_masks(tmp_path, monkeypatch, spill):
    """MaskStore.group_masks: the OR of every round's masks of a group of
    batches, whether the rounds stay as they are (one kept round: its own
    tensors), were restored as arrays, or spilled to files; group_size
    follows TWOPACO_MASK_SPILL_BYTES."""
    from twopaco_tpu_torch.passes import bloompipe

    rng = np.random.default_rng(4)
    n_b, rows, width = 5, 3, P // 8
    rounds = [rng.integers(0, 256, size=(n_b, rows, width)).astype(np.uint8) for _ in range(3)]
    monkeypatch.setenv("TWOPACO_MASK_SPILL_BYTES", str(2 * rows * width if spill else 1 << 30))
    store = bloompipe.MaskStore(str(tmp_path), est_bytes=sum(r.nbytes for r in rounds))
    assert (store.dir is not None) == spill
    assert store.group_size(rows * width) == (2 if spill else 1 << 62)
    store.add_round([torch.from_numpy(m) for m in rounds[0]])
    store.add_round(list(rounds[1]))  # a round restored from a checkpoint
    store.add_round([torch.from_numpy(m) for m in rounds[2]])
    want = rounds[0] | rounds[1] | rounds[2]
    for g0, g1 in ((0, 2), (2, 4), (4, 5), (0, 5)):
        got = store.group_masks(g0, g1, torch.device("cpu"))
        assert len(got) == g1 - g0
        assert np.array_equal(np.stack([m.numpy() for m in got]), want[g0:g1])
    store.cleanup()
    one = bloompipe.MaskStore(None, est_bytes=0)
    kept = [torch.from_numpy(m) for m in rounds[0]]
    one.add_round(kept)
    assert all(a is b for a, b in zip(one.group_masks(1, 4, torch.device("cpu")), kept[1:4]))
