"""Histograms of a batch's positions in 2^16 bins: by vertex hash, for
splitting the hash space into rounds of equal size
(TWOPACO_UNIFORM_SPLIT=0, and the dist engine's rounds), and by canonical
word0, for the dist engine's routing bounds.

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


def _check_hist_args(packed, nmask, valid, k: int, P: int, out):
    """The kernels' argument checks; -> out, or a new zeroed one."""
    build.require(packed, torch.uint32, "packed")
    build.require(nmask, torch.uint32, "nmask")
    build.require(valid, torch.int32, "valid")
    if packed.shape[1] * 16 < P + k + 1 or valid.shape != packed.shape[:1]:
        raise ValueError("batch shapes do not hold rows of P + k + 1 chars")
    if out is None:
        out = torch.zeros(1 << BIN_POW, dtype=torch.int32, device=packed.device)
    build.require(out, torch.int32, "out")
    if out.shape != (1 << BIN_POW,) or out.device != packed.device:
        raise ValueError(f"out: expected ({1 << BIN_POW},) on {packed.device}")
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
    out = _check_hist_args(packed, nmask, valid, k, P, out)
    packed, nmask, valid = _leading_rows(packed, nmask, valid, stride)
    rc = build.lib().tp_histogram(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), packed.shape[0],
        P, k, packed.shape[1], nmask.shape[1], *bz.TABLE_1, out.data_ptr(),
        build.stream_ptr(),
    )
    build.check(rc, "histogram_vertex_hashes")
    build.count_launch("histogram")
    return out


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
    out = _check_hist_args(packed, nmask, valid, k, P, out)
    rc = build.lib().tp_word0_histogram(
        packed.data_ptr(), nmask.data_ptr(), valid.data_ptr(), packed.shape[0],
        P, k, packed.shape[1], nmask.shape[1], out.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "word0_histogram")
    build.count_launch("word0_histogram")
    return out


def histogram_scan(uploads, *, k: int, P: int, stride: int = 1,
                   fn=histogram_vertex_hashes) -> np.ndarray:
    """The histogram of every batch of the run, summed (twopaco_tpu
    sortpipe.py:282 _histogram_scan). -> (2^16,) numpy int64."""
    dev = uploads[0][0].device
    acc = torch.zeros(1 << BIN_POW, dtype=torch.int32, device=dev)
    for packed, nmask, valid in uploads:
        fn(packed, nmask, valid, k=k, P=P, stride=stride, out=acc)
    return acc.cpu().numpy().astype(np.int64)
