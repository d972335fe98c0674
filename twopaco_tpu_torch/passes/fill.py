"""Bloom fill: insert a window batch's canonical edges into the filter
(pass 1 of the Bloom engine).

The port of twopaco_tpu/passes/kernels.py:257 pass1_fill (indices of
:130 fill_indices and :179 fill_indices_block). CUDA tensors go through
kernels/csrc/bloom_fill.cu; CPU tensors through `bloom_fill_plain`, which
computes the JAX package's index arrays in plain PyTorch (prefix-XOR hash
scans, int64 holding u32 values) and sets them with ops/bloom.py.

Also the plain helpers the other Bloom passes share: the codes of the
upload form and the per-table strand hashes.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32

LAYOUTS = {"byte": 0, "bit": 1, "block": 2}
ALL_TABLES = (bz.TABLE_1, bz.TABLE_2, bz.TABLE_3, bz.TABLE_4)


def batch_codes(packed, nmask, cfg) -> torch.Tensor:
    """The upload form -> (B, P+k+1) int64 codes (4 = N)."""
    return pack.unpack_codes(packed, nmask, cfg.P + cfg.k + 1).to(torch.int64)


def tables(cfg):
    """Tables 1-2, or 1-4 when f > 32 (the block layout uses 1-2 only)."""
    if cfg.layout != "block" and cfg.f > 32:
        return ALL_TABLES
    return ALL_TABLES[:2]


def hash_state(codes, cfg, tabs, n_out: int):
    """[(hf, hr)] per table: the strand hashes of the k-char windows at
    offsets 0 .. n_out-1 (offset j = chars [j, j+k); position i is offset
    i+1)."""
    return [bz.window_hashes(*bz.hash_scans(codes, t), cfg.k, n_out) for t in tabs]


def within(h, low: int, high: int):
    return (h >= low) & (h <= high)


def pos_ok(valid, P: int):
    return torch.arange(P, device=valid.device)[None, :] < valid.to(torch.int64)[:, None]


def probe_idx(sym, cfg):
    """KM indices (..., q) from one symmetric edge hash a table."""
    if cfg.f <= 32:
        return bz.probe_indices_from_sym(sym[0], sym[1], cfg.q, cfg.f)
    return bz.probe_indices_from_sym(sym[0], sym[1], cfg.q, cfg.f, e3=sym[2], e4=sym[3])


def _fill_common(codes, cfg, tabs):
    k, P = cfg.k, cfg.P
    state = hash_state(codes, cfg, tabs, P + 2)  # offsets 0 .. P+1
    def_all = pack.window_all_definite(codes, k, P + 2)
    hv_all = (state[0][0] + state[0][1]) & MASK32
    hfhr = [(hf[:, 1 : P + 1], hr[:, 1 : P + 1]) for hf, hr in state]
    return (
        hfhr, hv_all[:, 1 : P + 1], hv_all[:, 2 : P + 2],
        def_all[:, 1 : P + 1], def_all[:, 2 : P + 2],
        codes[:, 0:P], codes[:, k + 1 : k + 1 + P],
    )


def fill_indices(codes, valid, low: int, high: int, cfg):
    """Byte and bit layouts: -> (idx (B, P, 4, q) int64, valid mask of the
    same shape), as twopaco_tpu kernels.py:130 fill_indices: the out-edge
    V·next (V·A when next is N), dummy V·T when next is N, dummy A·V and T·V
    when prev is N, for definite V whose own or next vertex hash is in
    [low, high]."""
    k = cfg.k
    tabs = tables(cfg)
    hfhr, hv, hvn, defV, defVn, prev, nxt = _fill_common(codes, cfg, tabs)
    in_round = within(hv, low, high) | (defVn & within(hvn, low, high))
    base = pos_ok(valid, cfg.P) & defV & in_round
    next_def = nxt < 4
    prev_def = prev < 4
    c0 = torch.where(next_def, nxt, 0)
    slot_defs = [
        (lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, c0, k), base),
        (lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, 3, k), base & ~next_def),
        (lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 0, k), base & ~prev_def),
        (lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 3, k), base & ~prev_def),
    ]
    idx = torch.stack(
        [probe_idx([mk(t, hf, hr) for t, (hf, hr) in zip(tabs, hfhr)], cfg)
         for mk, _v in slot_defs],
        dim=2,
    )
    val = torch.stack([v for _mk, v in slot_defs], dim=2)[..., None].expand(idx.shape)
    return idx, val


def fill_indices_block(codes, valid, low: int, high: int, cfg):
    """Block layout: -> (block (B, P, 5), bits (B, P, 5, q), valid (B, P, 5)),
    as twopaco_tpu kernels.py:179 fill_indices_block: slot 1 V·next (or
    V·A) into block(V); 2 the same real edge into block(V_next); 3 dummy V·T
    into block(V); 4, 5 dummy A·V, T·V into block(V)."""
    k = cfg.k
    tabs = tables(cfg)
    hfhr, hv, hvn, defV, defVn, prev, nxt = _fill_common(codes, cfg, tabs)
    ok = pos_ok(valid, cfg.P)
    base_v = ok & defV & within(hv, low, high)
    next_def = nxt < 4
    prev_def = prev < 4
    (t1, t2), ((hf1, hr1), (hf2, hr2)) = tabs, hfhr
    c0 = torch.where(next_def, nxt, 0)

    def ebits(mk):
        return bloom.block_bits(mk(t1, hf1, hr1), mk(t2, hf2, hr2), cfg.q)

    b_out_c0 = ebits(lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, c0, k))
    b_out_t = ebits(lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, 3, k))
    b_in_a = ebits(lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 0, k))
    b_in_t = ebits(lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 3, k))
    wV = bloom.block_index(hv, cfg.f)
    wVn = bloom.block_index(hvn, cfg.f)
    block = torch.stack([wV, wVn, wV, wV, wV], dim=2)
    bits = torch.stack([b_out_c0, b_out_c0, b_out_t, b_in_a, b_in_t], dim=2)
    val = torch.stack(
        [
            base_v,
            ok & defV & next_def & defVn & within(hvn, low, high),
            base_v & ~next_def,
            base_v & ~prev_def,
            base_v & ~prev_def,
        ],
        dim=2,
    )
    return block, bits, val


def bloom_fill_plain(filt, packed, nmask, valid, low: int, high: int, *, cfg):
    """Plain PyTorch version of bloom_fill (any device)."""
    codes = batch_codes(packed, nmask, cfg)
    if cfg.layout == "block":
        return bloom.fill_blocks(filt, *fill_indices_block(codes, valid, low, high, cfg))
    idx, val = fill_indices(codes, valid, low, high, cfg)
    return bloom.fill(filt, idx, val, cfg.layout)


def check_filter(filt, cfg) -> None:
    """The filter tensor must be make_filter(cfg.f, cfg.layout)'s shape."""
    want = bloom.make_filter(cfg.f, cfg.layout, device="meta")
    if filt.shape != want.shape or filt.dtype != want.dtype:
        raise ValueError(
            f"filter {filt.dtype} {tuple(filt.shape)} is not the {cfg.layout} "
            f"layout's {want.dtype} {tuple(want.shape)} at f={cfg.f}"
        )
    if not filt.is_contiguous():
        raise ValueError("filter: must be contiguous")


def check_batch(packed, nmask, valid, cfg) -> None:
    """Types and shapes of an upload-form batch for a Bloom kernel, and
    the layout's capacity for a whole 2^f-slot filter on one device."""
    check_upload(packed, nmask, valid, cfg)
    if cfg.layout not in LAYOUTS:
        raise ValueError(f"unknown Bloom layout {cfg.layout!r}")
    bloom.check_layout_slots(1 << cfg.f, cfg.layout)


def check_upload(packed, nmask, valid, cfg) -> None:
    """Types and shapes of an upload-form batch of P positions a row, and
    q >= 1 hash functions."""
    build.require(packed, torch.uint32, "packed")
    build.require(nmask, torch.uint32, "nmask")
    build.require(valid, torch.int32, "valid")
    R = cfg.P + cfg.k + 1
    if (packed.shape[1] * 16 < R or nmask.shape[1] * 32 < R
            or valid.shape != packed.shape[:1] or nmask.shape[0] != packed.shape[0]):
        raise ValueError(
            f"batch shapes {tuple(packed.shape)}, {tuple(nmask.shape)}, "
            f"{tuple(valid.shape)} do not hold rows of {R} chars"
        )
    if cfg.P % 8:
        raise ValueError(f"P = {cfg.P} must be a multiple of 8 (packed masks)")
    if cfg.q < 1:
        raise ValueError(f"q = {cfg.q}: at least one hash function")


def bloom_fill(filt, packed, nmask, valid, low: int, high: int, *, cfg):
    """Insert the canonical edges of one batch into the filter, in place.

    filt: bloom.make_filter(cfg.f, cfg.layout) on the batch's device;
    packed (B, ceil(R/16)) uint32, nmask (B, ceil(R/32)) uint32, valid (B,)
    int32: the upload form of pack.pack_codes_host (R = P+k+1); [low, high]:
    the round's inclusive vertex-hash interval. -> filt.
    """
    if build.on_cpu(filt, packed, nmask, valid):
        return bloom_fill_plain(filt, packed, nmask, valid, low, high, cfg=cfg)
    check_batch(packed, nmask, valid, cfg)
    check_filter(filt, cfg)
    if filt.device != packed.device:
        raise ValueError(f"filter on {filt.device}, batch on {packed.device}")
    rc = build.lib().tp_bloom_fill(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), packed.shape[0],
        cfg.P, cfg.k, packed.shape[1], nmask.shape[1], int(low), int(high),
        build.hash_tables(ALL_TABLES), cfg.q, cfg.f, LAYOUTS[cfg.layout],
        filt.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "bloom_fill")
    build.count_launch("bloom_fill")
    return filt
