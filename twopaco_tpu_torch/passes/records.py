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


def _comp4(x: torch.Tensor) -> torch.Tensor:
    """Complement of an extension code; N (4) stays N."""
    return torch.where(x < 4, 3 - x, 4)


def build_sort_records_plain(
    packed, nmask, valid, pos_base: int, *, k: int, P: int,
    low: int = 0, high: int = MASK32, out=None,
):
    """Plain PyTorch version of build_sort_records (any device)."""
    R = P + k + 1
    codes = pack.unpack_codes(packed, nmask, R).to(torch.int64)
    B = codes.shape[0]
    cm = torch.where(codes < 4, codes, 0)
    words_all = pack.kmer_words(cm, k, P + 2)  # offset j = chars [j, j+k)
    rc_all = pack.revcomp_words(words_all, k)
    def_all = pack.window_all_definite(codes, k, P + 2)
    # vertex i of a row is offset i+1; prev = char i, next = char i+k+1
    canon, is_rc = pack.canonical(words_all[:, 1 : P + 1], rc_all[:, 1 : P + 1])
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    hf, hr = bz.window_hashes(*bz.hash_scans(codes, bz.TABLE_1), k, P + 1)
    hv = (hf[:, 1 : P + 1] + hr[:, 1 : P + 1]) & MASK32
    col = torch.arange(P, device=codes.device)[None, :]
    ok = (
        (col < valid.to(torch.int64)[:, None])
        & def_all[:, 1 : P + 1]
        & (hv >= low)
        & (hv <= high)
    )
    in_code = torch.where(is_rc, _comp4(nxt), prev)
    out_code = torch.where(is_rc, _comp4(prev), nxt)
    payload = in_code | (out_code << 8) | (is_rc.to(torch.int64) << 16) | (1 << 17)
    payload = torch.where(ok, payload, 0)
    words = torch.where(ok[..., None], canon, MASK32)
    res = (
        pack.as_u32(words.reshape(B * P, -1)),
        pack.as_u32(payload.reshape(-1)),
        pos_base + torch.arange(B * P, device=codes.device),
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
    low: int = 0, high: int = MASK32, out=None,
):
    """One record per vertex position of a batch of B rows x P positions.

    packed (B, ceil(R/16)) uint32 and nmask (B, ceil(R/32)) uint32 are
    the upload form of pack.pack_codes_host (R = P+k+1); valid (B,)
    int32; pos_base = global flat position of the batch's first slot
    (row0 * P). Records whose window holds an N, lies past the row's
    valid count, or whose vertex hash is outside [low, high] become
    all-ones sentinel rows with payload 0.

    out: optional (words (B*P, w) uint32, payload (B*P,) uint32, pos
    (B*P,) int64) slices of the round buffer to write into.
    -> (words, payload = in | out<<8 | is_rc<<16 | real<<17, pos)
    """
    B = packed.shape[0]
    n, w = B * P, pack.n_words(k)
    if build.on_cpu(packed, nmask, valid):
        return build_sort_records_plain(
            packed, nmask, valid, pos_base, k=k, P=P, low=low, high=high,
            out=out,
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
        *bz.TABLE_1, words.data_ptr(), payload.data_ptr(), pos.data_ptr(),
        build.stream_ptr(),
    )
    build.check(rc, "build_sort_records")
    build.count_launch("build_records")
    return out
