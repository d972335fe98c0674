"""Histograms of a batch's positions in 2^16 bins: by vertex hash, for
splitting the hash space into rounds of equal size
(TWOPACO_UNIFORM_SPLIT=0, and the dist engine's rounds), and by canonical
word0, for the dist engine's routing bounds. The `_batches` entries sum
a list of resident batches in one launch (histogram_scan; a dist shard's
measurement pass); the per-batch ones are the JAX functions' counterparts.

The port of twopaco_tpu/passes/kernels.py:582 histogram_vertex_hashes,
twopaco_tpu/passes/sortpipe.py:282 _histogram_scan and
twopaco_tpu/parallel/distpipe.py:102 word0_histogram. CUDA tensors go
through kernels/csrc/histogram.cu; CPU tensors through
`histogram_vertex_hashes_plain` and `word0_histogram_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import buzhash as bz
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import records

BIN_POW = 16


def _leading_rows(packed, nmask, valid, stride: int):
    rows = max(packed.shape[0] // stride, 1)
    return packed[:rows], nmask[:rows], valid[:rows]


def _check_out(out, device):
    """out, or a new zeroed (2^16,) int32 on device."""
    if out is None:
        return torch.zeros(1 << BIN_POW, dtype=torch.int32, device=device)
    build.require(out, torch.int32, "out")
    if out.shape != (1 << BIN_POW,) or out.device != device:
        raise ValueError(f"out: expected ({1 << BIN_POW},) on {device}")
    return out


def histogram_vertex_hashes_plain(packed, nmask, valid, *, k: int, P: int,
                                  stride: int = 1, out=None):
    """Plain PyTorch version of histogram_vertex_hashes (any device)."""
    packed, nmask, valid = _leading_rows(packed, nmask, valid, stride)
    codes = pack.unpack_codes(packed, nmask, P + k + 1).to(torch.int64)
    hv, ok = records.vertex_hashes_plain(codes, valid, k=k, P=P)
    h = torch.bincount(hv[ok] >> (32 - BIN_POW), minlength=1 << BIN_POW).to(torch.int32)
    if out is None:
        return h
    out += h
    return out


def histogram_vertex_hashes(packed, nmask, valid, *, k: int, P: int,
                            stride: int = 1, out=None):
    """Counts of the vertex hashes of a batch in 2^16 bins (bin = hv >>
    16), over every position that has a record (inside its row's valid
    count, no N in its window). stride > 1 counts only the leading
    max(B // stride, 1) rows: an unbiased sample, since hash-bin mass does
    not depend on where a row lies in the genome.

    -> (2^16,) int32; with out, the counts are added to it and out is
    returned (one buffer sums a run's batches)."""
    if build.on_cpu(packed, nmask, valid):
        return histogram_vertex_hashes_plain(
            packed, nmask, valid, k=k, P=P, stride=stride, out=out
        )
    return _histogram_batches([(packed, nmask, valid)], k, P, stride, out, False, "histogram")


def word0_histogram_plain(packed, nmask, valid, *, k: int, P: int, out=None):
    """Plain PyTorch version of word0_histogram (any device)."""
    canon, _pay, _hv, ok = records.batch_records_plain(packed, nmask, valid, k=k, P=P)
    h = torch.bincount(canon[ok, 0] >> (32 - BIN_POW), minlength=1 << BIN_POW).to(torch.int32)
    if out is None:
        return h
    out += h
    return out


def word0_histogram(packed, nmask, valid, *, k: int, P: int, out=None):
    """Counts of the canonical k-mers' first word of a batch in 2^16 bins
    (bin = word0 >> 16), over every position that has a record (inside
    its row's valid count, no N in its window; no round gate).

    -> (2^16,) int32; with out, the counts are added to it and out is
    returned."""
    if build.on_cpu(packed, nmask, valid):
        return word0_histogram_plain(packed, nmask, valid, k=k, P=P, out=out)
    return _histogram_batches([(packed, nmask, valid)], k, P, 1, out, True, "word0_histogram")


def _batches_table(uploads, k: int, P: int, stride: int):
    """The kernels' checks of every batch (one device: the caller's
    on_cpu), and the rows of tp_histogram_batches' table: (packed, nmask,
    valid pointers, first position, rows, RW, NW, 0) of each batch's
    leading max(B // stride, 1) rows, which start where the batch starts
    -> (rows, positions of the call). A few Python
    operations a batch: a shard's 123 batches take well under a
    millisecond of host time."""
    u32, i32 = torch.uint32, torch.int32
    rows_ = []
    n = 0
    for packed, nmask, valid in uploads:
        if not (packed.dtype == u32 and nmask.dtype == u32 and valid.dtype == i32
                and packed.is_contiguous() and nmask.is_contiguous()
                and valid.is_contiguous()):
            for t, dtype, name in ((packed, u32, "packed"), (nmask, u32, "nmask"),
                                   (valid, i32, "valid")):
                build.require(t, dtype, name)  # raises, naming the fault
        B, RW = packed.shape
        if RW * 16 < P + k + 1 or valid.shape != (B,):
            raise ValueError("batch shapes do not hold rows of P + k + 1 chars")
        rows = min(max(B // stride, 1), B)
        if rows * P >= 1 << 32:
            raise ValueError(f"a batch of {rows} rows of {P} positions exceeds u32 positions")
        rows_.append((packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), n, rows, RW,
                      nmask.shape[1], 0))
        n += rows * P
    return rows_, n


def _histogram_batches(uploads, k: int, P: int, stride: int, out, word0: bool, name: str):
    out = _check_out(out, uploads[0][0].device)
    table, n = _batches_table(uploads, k, P, stride)
    # pinned, so that the copy needs no wait for the stream's earlier work
    table = torch.tensor(table, dtype=torch.int64).pin_memory().to(out.device,
                                                                   non_blocking=True)
    rc = build.lib().tp_histogram_batches(
        table.data_ptr(), len(uploads), n, P, k, int(word0), *bz.TABLE_1, out.data_ptr(),
        build.stream_ptr(),
    )
    build.check(rc, name)
    build.count_launch(name)
    return out


def _on_cpu(uploads, out) -> bool:
    if not uploads:
        raise ValueError("no batches")
    return build.on_cpu(*(t for u in uploads for t in u), *(() if out is None else (out,)))


def histogram_vertex_hashes_batches_plain(uploads, *, k: int, P: int, stride: int = 1,
                                          out=None):
    """Plain PyTorch version of histogram_vertex_hashes_batches: the
    per-batch plain function over the batches (any device)."""
    out = _check_out(out, uploads[0][0].device)
    for packed, nmask, valid in uploads:
        histogram_vertex_hashes_plain(packed, nmask, valid, k=k, P=P, stride=stride, out=out)
    return out


def histogram_vertex_hashes_batches(uploads, *, k: int, P: int, stride: int = 1, out=None):
    """histogram_vertex_hashes summed over a list of (packed, nmask, valid)
    batches on one device, in one launch (each batch's leading max(B //
    stride, 1) rows). -> (2^16,) int32; with out, added to out."""
    if _on_cpu(uploads, out):
        return histogram_vertex_hashes_batches_plain(uploads, k=k, P=P, stride=stride, out=out)
    return _histogram_batches(uploads, k, P, stride, out, False, "histogram")


def word0_histogram_batches_plain(uploads, *, k: int, P: int, out=None):
    """Plain PyTorch version of word0_histogram_batches: the per-batch
    plain function over the batches (any device)."""
    out = _check_out(out, uploads[0][0].device)
    for packed, nmask, valid in uploads:
        word0_histogram_plain(packed, nmask, valid, k=k, P=P, out=out)
    return out


def word0_histogram_batches(uploads, *, k: int, P: int, out=None):
    """word0_histogram summed over a list of (packed, nmask, valid) batches
    on one device (a dist shard's resident batches), in one launch.
    -> (2^16,) int32; with out, added to out."""
    if _on_cpu(uploads, out):
        return word0_histogram_batches_plain(uploads, k=k, P=P, out=out)
    return _histogram_batches(uploads, k, P, 1, out, True, "word0_histogram")


def histogram_scan(uploads, *, k: int, P: int, stride: int = 1,
                   fn=histogram_vertex_hashes_batches) -> np.ndarray:
    """The histogram of every batch of the run, summed (twopaco_tpu
    sortpipe.py:282 _histogram_scan): fn, a batched histogram
    (histogram_vertex_hashes_batches, one launch a run on the card, or its
    plain version), over the uploads. -> (2^16,) numpy int64."""
    return fn(uploads, k=k, P=P, stride=stride).cpu().numpy().astype(np.int64)
