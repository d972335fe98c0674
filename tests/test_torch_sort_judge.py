"""Port round sort and judge against twopaco_tpu sortpipe.sort_records
and judge_compact_fused (CPU tensors: the plain versions).

lax.sort is not stable, so the sort is held to equal keys and, per key,
equal multisets of (payload, position). The judges are then fed the same
sorted records, and both compact in record order: table, occurrences and
counts must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.passes import sortpipe as jsort
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import judge, sort

B, P = 8, 128
NO_AB = judge.NO_ABUNDANCE


def _genome_records(k, seed, n_batches=2):
    """Records of a few related genomes, built by the JAX package."""
    rng = np.random.default_rng(seed)
    R = P + k + 1
    cfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    base = rng.integers(0, 4, size=3 * R).astype(np.uint8)
    cols = []
    for bi in range(n_batches):
        codes = np.stack([base[s : s + R] for s in rng.integers(0, 2 * R, size=B)])
        flip = rng.random(codes.shape) < 0.01
        codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
        codes[rng.random(codes.shape) < 0.005] = 4
        valid = np.full(B, P, np.int32)
        valid[-1] = P // 3
        packed, nmask = pack.pack_codes_host(codes)
        cols.append(jsort.build_sort_records(
            (jnp.asarray(packed), jnp.asarray(nmask)), jnp.asarray(valid),
            jsort._pos_base(bi * B, P, False), jnp.uint32(0),
            jnp.uint32(0xFFFFFFFF), cfg=cfg,
        ))
    words = np.concatenate([np.asarray(c[0]) for c in cols])
    pay = np.concatenate([np.asarray(c[1]) for c in cols])
    pos = np.concatenate([np.asarray(c[2][0]) for c in cols]).astype(np.int64)
    return words, pay, pos


def _random_records(w, m, seed):
    """Random keys with many duplicates, high-bit words and sentinels."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    dup = rng.random(m) < 0.7
    words[dup] = words[rng.integers(0, m // 16, size=int(dup.sum()))]
    sent = rng.random(m) < 0.15
    words[sent] = 0xFFFFFFFF
    ext = rng.integers(0, 5, size=(m, 2)).astype(np.uint32)
    pay = ext[:, 0] | (ext[:, 1] << 8) | (rng.integers(0, 2, m).astype(np.uint32) << 16)
    pay = np.where(sent, 0, pay | (1 << 17)).astype(np.uint32)
    pos = rng.permutation(m).astype(np.int64) * 3
    return words, pay, pos


CASES = {
    "genome_k25": lambda: _genome_records(25, 1),
    "genome_k101": lambda: _genome_records(101, 2),
    "random_w2": lambda: _random_records(2, 2048, 3),
    "random_w7": lambda: _random_records(7, 2048, 4),
}


def _canon_rows(words, pay, pos):
    """Rows ordered by (words..., payload, pos): a per-key multiset view."""
    cols = [pos, pay] + [words[:, j] for j in reversed(range(words.shape[1]))]
    o = np.lexsort(cols)
    return words[o], pay[o], pos[o]


def _torch(words, pay, pos):
    return torch.from_numpy(words), torch.from_numpy(pay), torch.from_numpy(pos)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_matches_jax(case):
    words, pay, pos = CASES[case]()
    w = words.shape[1]
    jw, jp, jpos = jsort.sort_records(
        jnp.asarray(words), jnp.asarray(pay), (jnp.asarray(pos.astype(np.uint32)),), w=w
    )
    tw, tp, tpos = sort.sort_records(*_torch(words, pay, pos))
    jw, jp, jpos = np.asarray(jw), np.asarray(jp), np.asarray(jpos[0]).astype(np.int64)
    assert np.array_equal(tw.numpy(), jw)  # keys in the same order
    assert (tw.numpy()[-1] == 0xFFFFFFFF).all()  # sentinels last
    for a, b in zip(_canon_rows(tw.numpy(), tp.numpy(), tpos.numpy()), _canon_rows(jw, jp, jpos)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("abundance", [NO_AB, 3])
def test_judge_matches_jax(case, abundance):
    sw, sp, spos = sort.sort_records(*_torch(*CASES[case]()))
    m, w = sw.shape
    got = judge.judge_compact(sw, sp, spos, abundance)
    tab, op, oi, ng, nj, no = jsort.judge_compact_fused(
        jnp.asarray(sw.numpy()), jnp.asarray(sp.numpy()),
        (jnp.asarray(spos.numpy().astype(np.uint32)),), jnp.uint64(abundance),
        check_abundance=abundance < NO_AB, chunk=m // 4,
    )
    nj, no = int(nj), int(no)
    assert got[3:] == (int(ng), nj, no)
    assert 0 < nj < int(ng)
    assert np.array_equal(got[0].numpy(), np.asarray(tab)[:nj])
    assert np.array_equal(got[1].numpy(), np.asarray(op[0])[:no].astype(np.int64))
    assert np.array_equal(got[2].numpy(), np.asarray(oi)[:no])


def test_judge_all_sentinels_and_empty():
    w = 2
    sent = torch.full((64, w), 0xFFFFFFFF, dtype=torch.int64)
    got = judge.judge_compact(
        pack.as_u32(sent), torch.zeros(64, dtype=torch.uint32),
        torch.arange(64),
    )
    assert got[3:] == (0, 0, 0) and got[0].shape == (0, w)
    empty = judge.judge_compact(
        torch.empty((0, w), dtype=torch.uint32),
        torch.empty(0, dtype=torch.uint32), torch.empty(0, dtype=torch.int64),
    )
    assert empty[3:] == (0, 0, 0)
