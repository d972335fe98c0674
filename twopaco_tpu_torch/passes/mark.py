"""Bloom mark: the candidate mask of a window batch (pass 2 of the Bloom
engine).

The port of twopaco_tpu/passes/kernels.py:400 pass2_mark (probes of :273
mark_indices and :357 mark_indices_block, decision :315 mark_decide,
packing :336 pack_mask). CUDA tensors go through kernels/csrc/bloom_mark.cu;
CPU tensors through `bloom_mark_plain`.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes import fill

_MSB_FIRST = (128, 64, 32, 16, 8, 4, 2, 1)


def mark_common(codes, valid, low: int, high: int, cfg, tabs):
    """-> ([(hf, hr)] per table of tabs at the P positions, vertex hash hv,
    base (a record, hv in [low, high]), prev, nxt): (B, P) each."""
    k, P = cfg.k, cfg.P
    state = fill.hash_state(codes, cfg, tabs, P + 1)  # offsets 0 .. P
    defV = pack.window_all_definite(codes, k, P + 1)[:, 1 : P + 1]
    hv = (state[0][0][:, 1 : P + 1] + state[0][1][:, 1 : P + 1]) & MASK32
    base = fill.pos_ok(valid, P) & defV & fill.within(hv, low, high)
    hfhr = [(hf[:, 1 : P + 1], hr[:, 1 : P + 1]) for hf, hr in state]
    return hfhr, hv, base, codes[:, 0:P], codes[:, k + 1 : k + 1 + P]


def _edge_syms(hfhr, tabs, k):
    """[per slot: [per table: symmetric edge hash]]: slots 0..3 in-edges
    c·V, 4..7 out-edges V·c for c = A, C, G, T."""
    return [
        [edge(hf, hr, t, c, k) for t, (hf, hr) in zip(tabs, hfhr)]
        for edge in (bz.in_edge_sym, bz.out_edge_sym)
        for c in range(4)
    ]


def mark_indices(codes, valid, low: int, high: int, cfg):
    """Byte and bit layouts: -> (idx (B, P, 8, q), base, prev, nxt)."""
    tabs = fill.tables(cfg)
    hfhr, _hv, base, prev, nxt = mark_common(codes, valid, low, high, cfg, tabs)
    idx = torch.stack([fill.probe_idx(s, cfg) for s in _edge_syms(hfhr, tabs, cfg.k)], dim=2)
    return idx, base, prev, nxt


def mark_indices_block(codes, valid, low: int, high: int, cfg):
    """Block layout: -> (block (B, P), bits (B, P, 8, q), base, prev, nxt)."""
    tabs = fill.tables(cfg)
    hfhr, hv, base, prev, nxt = mark_common(codes, valid, low, high, cfg, tabs)
    bits = torch.stack(
        [bloom.block_bits(e1, e2, cfg.q) for e1, e2 in _edge_syms(hfhr, tabs, cfg.k)], dim=2
    )
    return bloom.block_index(hv, cfg.f), bits, base, prev, nxt


def mark_decide(hits, base, prev, nxt):
    """Candidate decision from the per-slot Bloom hits (B, P, 8)
    (reference CandidateCheckingWorker, vertexenumerator.h:633-674)."""
    in_cnt = 2 * (prev >= 4).to(torch.int64)
    out_cnt = 2 * (nxt >= 4).to(torch.int64)
    for c in range(4):
        in_cnt = in_cnt + torch.where(prev == c, 1, hits[:, :, c].to(torch.int64))
        out_cnt = out_cnt + torch.where(nxt == c, 1, hits[:, :, 4 + c].to(torch.int64))
    return base & ((in_cnt > 1) | (out_cnt > 1))


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, P) bool -> (B, P/8) uint8, MSB first (np.unpackbits order)."""
    B, P = mask.shape
    w = torch.tensor(_MSB_FIRST, dtype=torch.int64, device=mask.device)
    return (mask.reshape(B, P // 8, 8).to(torch.int64) * w).sum(-1).to(torch.uint8)


def unpack_mask(packed: torch.Tensor, P: int) -> torch.Tensor:
    """(B, P/8) uint8 -> (B, P) bool."""
    shifts = torch.arange(7, -1, -1, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :P] > 0


def bloom_mark_plain(filt, packed, nmask, valid, low: int, high: int, *, cfg):
    """Plain PyTorch version of bloom_mark (any device)."""
    codes = fill.batch_codes(packed, nmask, cfg)
    if cfg.layout == "block":
        block, bits, base, prev, nxt = mark_indices_block(codes, valid, low, high, cfg)
        hits = bloom.probe_blocks(filt, block, bits)
    else:
        idx, base, prev, nxt = mark_indices(codes, valid, low, high, cfg)
        hits = bloom.probe_all(filt, idx, cfg.layout)
    mask = mark_decide(hits, base, prev, nxt)
    return pack_mask(mask), mask.sum(dtype=torch.int64)


def bloom_mark(filt, packed, nmask, valid, low: int, high: int, *, cfg):
    """Candidate positions of one batch against the round's filter.

    Arguments as fill.bloom_fill's. -> (mask (B, P/8) uint8, the candidates
    packed 8 a byte MSB first; count, a 0-d int64 tensor on the device)."""
    if build.on_cpu(filt, packed, nmask, valid):
        return bloom_mark_plain(filt, packed, nmask, valid, low, high, cfg=cfg)
    fill.check_batch(packed, nmask, valid, cfg)
    fill.check_filter(filt, cfg)
    if filt.device != packed.device:
        raise ValueError(f"filter on {filt.device}, batch on {packed.device}")
    B = packed.shape[0]
    mask = torch.empty((B, cfg.P // 8), dtype=torch.uint8, device=packed.device)
    count = torch.zeros((), dtype=torch.int64, device=packed.device)
    rc = build.lib().tp_bloom_mark(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), B, cfg.P, cfg.k,
        packed.shape[1], nmask.shape[1], int(low), int(high),
        build.hash_tables(fill.ALL_TABLES), cfg.q, cfg.f, fill.LAYOUTS[cfg.layout],
        filt.data_ptr(), mask.data_ptr(), count.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "bloom_mark")
    build.count_launch("bloom_mark")
    return mask, count
