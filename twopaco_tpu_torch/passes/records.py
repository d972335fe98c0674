"""Record build: one sort record per vertex position of a window batch.

The port of twopaco_tpu/passes/sortpipe.py:143 build_sort_records (and
the append into the round buffer, :326 append_records). CUDA tensors go
through the kernel in kernels/csrc/records.cu; CPU tensors through
`build_sort_records_plain`, which computes the same function in plain
PyTorch the way the JAX package does (packed k-mer words, prefix-XOR
hash scans).
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes.mark import unpack_mask

REAL = 1 << 17  # payload bit of a real (in-round) record


def _comp4(x: torch.Tensor) -> torch.Tensor:
    """Complement of an extension code; N (4) stays N."""
    return torch.where(x < 4, 3 - x, 4)


def vertex_hashes_plain(codes, valid, *, k: int, P: int):
    """codes (B, P+k+1) int64 -> (hv (B, P) int64 vertex hashes, ok (B, P)
    bool: the position has a record, inside its row's valid count with no
    N in its window)."""
    hf, hr = bz.window_hashes(*bz.hash_scans(codes, bz.TABLE_1), k, P + 1)
    hv = (hf[:, 1 : P + 1] + hr[:, 1 : P + 1]) & MASK32
    col = torch.arange(P, device=codes.device)[None, :]
    ok = (col < valid.to(torch.int64)[:, None]) & pack.window_all_definite(
        codes, k, P + 1
    )[:, 1 : P + 1]
    return hv, ok


def canonical_records_plain(codes, *, k: int, P: int):
    """codes (B, P+k+1) int64 -> (canon (B*P, w) int64 canonical words of
    every position, payload (B*P,) int64 = in | out<<8 | is_rc<<16 without
    the real bit), whatever the position's window holds."""
    B = codes.shape[0]
    cm = torch.where(codes < 4, codes, 0)
    words_all = pack.kmer_words(cm, k, P + 2)  # offset j = chars [j, j+k)
    rc_all = pack.revcomp_words(words_all, k)
    # vertex i of a row is offset i+1; prev = char i, next = char i+k+1
    canon, is_rc = pack.canonical(words_all[:, 1 : P + 1], rc_all[:, 1 : P + 1])
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    in_code = torch.where(is_rc, _comp4(nxt), prev)
    out_code = torch.where(is_rc, _comp4(prev), nxt)
    payload = in_code | (out_code << 8) | (is_rc.to(torch.int64) << 16)
    return canon.reshape(B * P, -1), payload.reshape(-1)


def batch_records_plain(packed, nmask, valid, *, k: int, P: int):
    """Ungated records of every position of a batch (twopaco_tpu
    sortpipe.py:103 _batch_records), plain PyTorch.

    -> (canon (B*P, w) int64 canonical words, payload (B*P,) int64 = in |
    out<<8 | is_rc<<16 without the real bit, hv (B*P,) int64, ok (B*P,)
    bool)"""
    codes = pack.unpack_codes(packed, nmask, P + k + 1).to(torch.int64)
    canon, payload = canonical_records_plain(codes, k=k, P=P)
    hv, ok = vertex_hashes_plain(codes, valid, k=k, P=P)
    return canon, payload, hv.reshape(-1), ok.reshape(-1)


def build_sort_records_plain(
    packed, nmask, valid, pos_base: int, *, k: int, P: int,
    low: int = 0, high: int = MASK32, out=None, mask=None,
):
    """Plain PyTorch version of build_sort_records (any device)."""
    canon, payload, hv, ok = batch_records_plain(packed, nmask, valid, k=k, P=P)
    ok = ok & (hv >= low) & (hv <= high)
    if mask is not None:
        ok = ok & unpack_mask(mask, P).reshape(-1)
    payload = torch.where(ok, payload | REAL, 0)
    words = torch.where(ok[:, None], canon, MASK32)
    res = (
        pack.as_u32(words),
        pack.as_u32(payload),
        pos_base + torch.arange(len(payload), device=payload.device),
    )
    if out is None:
        return res
    for dst, src in zip(out, res):
        if dst.dtype == torch.uint32:  # copy through int32 views
            dst, src = dst.view(torch.int32), src.view(torch.int32)
        dst.copy_(src)
    return out


def build_sort_records(
    packed, nmask, valid, pos_base: int, *, k: int, P: int,
    low: int = 0, high: int = MASK32, out=None, mask=None,
):
    """One record per vertex position of a batch of B rows x P positions.

    packed (B, ceil(R/16)) uint32 and nmask (B, ceil(R/32)) uint32 are
    the upload form of pack.pack_codes_host (R = P+k+1); valid (B,)
    int32; pos_base = global flat position of the batch's first slot
    (row0 * P). Records whose window holds an N, lies past the row's
    valid count, or whose vertex hash is outside [low, high] become
    all-ones sentinel rows with payload 0.

    out: optional (words (B*P, w) uint32, payload (B*P,) uint32, pos
    (B*P,) int64) slices of the round buffer to write into. mask: optional
    (B, P/8) uint8 candidate mask (MSB first, the dist-bloom engine's
    gate, twopaco_tpu distpipe.py:168): a position whose bit is 0 becomes
    a sentinel row with payload 0 too.
    -> (words, payload = in | out<<8 | is_rc<<16 | real<<17, pos)
    """
    B = packed.shape[0]
    n, w = B * P, pack.n_words(k)
    gates = () if mask is None else (mask,)
    if build.on_cpu(packed, nmask, valid, *gates):
        return build_sort_records_plain(
            packed, nmask, valid, pos_base, k=k, P=P, low=low, high=high,
            out=out, mask=mask,
        )
    R = P + k + 1
    build.require(packed, torch.uint32, "packed")
    build.require(nmask, torch.uint32, "nmask")
    build.require(valid, torch.int32, "valid")
    if packed.shape[1] * 16 < R or nmask.shape[1] * 32 < R or valid.shape != (B,):
        raise ValueError(
            f"batch shapes {tuple(packed.shape)}, {tuple(nmask.shape)}, "
            f"{tuple(valid.shape)} do not hold rows of {R} chars"
        )
    if mask is not None:
        build.require(mask, torch.uint8, "mask")
        if P % 8 or mask.shape != (B, P // 8):
            raise ValueError(f"mask: expected ({B}, {P // 8}) with P % 8 == 0, got "
                             f"{tuple(mask.shape)} at P = {P}")
    dev = packed.device
    if out is None:
        out = (
            torch.empty((n, w), dtype=torch.uint32, device=dev),
            torch.empty(n, dtype=torch.uint32, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev),
        )
    words, payload, pos = out
    if words.shape != (n, w) or payload.shape != (n,) or pos.shape != (n,):
        raise ValueError("out buffers do not match the batch's B*P records")
    for t, dt, name in ((words, torch.uint32, "words"),
                        (payload, torch.uint32, "payload"),
                        (pos, torch.int64, "pos")):
        build.require(t, dt, name)
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, batch on {dev}")
    rc = build.lib().tp_build_records(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), B, P, k,
        packed.shape[1], nmask.shape[1], int(pos_base), int(low), int(high),
        *bz.TABLE_1, mask.data_ptr() if mask is not None else None,
        words.data_ptr(), payload.data_ptr(), pos.data_ptr(),
        build.stream_ptr(),
    )
    build.check(rc, "build_sort_records")
    build.count_launch("build_records")
    return out
