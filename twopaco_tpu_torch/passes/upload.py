"""Upload: every window row of a run packed on the device, from the run's
codes staged in one buffer.

Replaces the host packing of the JAX package's upload
(twopaco_tpu/passes/sortpipe.py:1048-1056: io/windows.py rows of uint8
codes, then ops/pack.py pack_codes_host a batch, then one copy an array),
which packs on the host to shrink the H2D over the TPU's remote link.
Here the staged codes (1 byte a char, io/fasta.py read_all_staged) go up
in spans (plan_chunks: one span where they fit), and the device writes
the upload form that every kernel reads (kernels/csrc/common.cuh):
packed (rows, ceil(R/16)) uint32, 2-bit chars little-first, and the N
mask (rows, ceil(R/32)) uint32, R = P+k+1, for all rows of a span at
once. A row reads its chars through the row table of
io/windows.py window_rows: (off, lo, hi) int64, char j is staged code
off + j when that lies in [lo, hi), else N (the prepended S'[0], the
appended S'[L+1] and the padding). Chars past R are 0 in both outputs,
as pack_codes_host leaves them.

CUDA tensors go through kernels/csrc/upload.cu; CPU tensors through
`pack_rows_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from twopaco_tpu_torch.kernels import build
from twopaco_tpu_torch.ops import pack

CODE_ALIGN = 16  # upload.cu reads the staged codes as aligned 16-byte words


def row_words(R: int) -> tuple[int, int]:
    """(packed, mask) u32 words a row of R chars takes."""
    return -(-R // 16), -(-R // 32)


def plan_chunks(table, R: int, rows_per_batch: int, n_codes: int, budget: int | None):
    """Cut a run's batches into chunks that pack from one span of the
    staged codes each.

    table: (n_batches * rows_per_batch, 3) int64 row table (off, lo, hi);
    a row reads the staged codes [max(off, lo), min(off + R, hi)). A
    chunk's span covers its rows' (rows follow input order, so consecutive
    batches read neighbouring spans), widened to CODE_ALIGN bytes within
    [0, n_codes); it costs its span's bytes and 24 table bytes a row on the
    device. Greedy: each chunk takes batches while its cost stays within
    budget (None: no limit), and at least one.

    -> ([(b0, b1, lo, hi)]: batches [b0, b1) pack from codes [lo, hi), the
    table offsets less lo), the largest one-batch cost)"""
    n_b = len(table) // rows_per_batch if rows_per_batch else 0
    t = np.asarray(table).reshape(n_b, rows_per_batch, 3)
    start = np.maximum(t[..., 0], t[..., 1])
    end = np.minimum(t[..., 0] + R, t[..., 2])
    real = end > start
    s_b = np.where(real, start, n_codes).min(axis=1, initial=n_codes) & ~(CODE_ALIGN - 1)
    e_b = np.minimum(-(-np.where(real, end, 0).max(axis=1, initial=0) // CODE_ALIGN)
                     * CODE_ALIGN, n_codes)
    full = e_b > s_b  # batches that read any code
    row_cost = 24 * rows_per_batch
    least = int((e_b - s_b)[full].max(initial=0)) + row_cost

    lo, hi = (int(s_b[full].min()), int(e_b[full].max())) if full.any() else (0, 0)
    if budget is None or hi - lo + row_cost * n_b <= budget:
        return [(0, n_b, lo, hi)], least
    chunks, b0 = [], 0
    while b0 < n_b:
        lo = hi = None  # the chunk's span, None while it reads no code
        b1 = b0
        while b1 < n_b:
            l2, h2 = lo, hi
            if full[b1]:
                l2 = s_b[b1] if lo is None else min(lo, s_b[b1])
                h2 = e_b[b1] if hi is None else max(hi, e_b[b1])
            cost = (0 if l2 is None else h2 - l2) + row_cost * (b1 + 1 - b0)
            if b1 > b0 and cost > budget:
                break
            lo, hi, b1 = l2, h2, b1 + 1
        chunks.append((b0, b1, int(lo or 0), int(hi or 0)))
        b0 = b1
    return chunks, least


def pack_rows_plain(codes, table, *, R: int, out=None):
    """Plain PyTorch version of pack_rows (any device)."""
    rows, dev = table.shape[0], table.device
    RW, NW = row_words(R)
    n = codes.numel()
    idx = table[:, :1] + torch.arange(R, device=dev)
    real = (idx >= table[:, 1:2].clamp(min=0)) & (idx < table[:, 2:3].clamp(max=n))
    if n:
        c = torch.where(real, codes[idx.clamp(0, n - 1)].to(torch.int64), 4)
    else:
        c = torch.full((rows, R), 4, dtype=torch.int64, device=dev)
    two = torch.nn.functional.pad(c & 3, (0, RW * 16 - R)).view(rows, RW, 16)
    isn = torch.nn.functional.pad((c >> 2) & 1, (0, NW * 32 - R)).view(rows, NW, 32)
    # disjoint bits: the sums are the ORs
    packed = pack.as_u32((two << (2 * torch.arange(16, device=dev))).sum(dim=2))
    nmask = pack.as_u32((isn << torch.arange(32, device=dev)).sum(dim=2))
    if out is None:
        return packed, nmask
    out[0].copy_(packed)
    out[1].copy_(nmask)
    return out


def pack_rows(codes, table, *, R: int, out=None):
    """The upload form of every row of a row table.

    codes: (n,) uint8 staged codes (0..4, 4 = N; a code's two low bits are
    its char, bit 2 its N flag), n a multiple of CODE_ALIGN; table: (rows,
    3) int64 (off, lo, hi) a row (io/windows.py window_rows); R: chars a
    row; out: the two outputs to write (contiguous), else new ones. ->
    (packed (rows, ceil(R/16)) uint32, nmask (rows, ceil(R/32)) uint32).
    Row b*B' .. of the outputs are batch b's rows: a batch's upload is a
    row slice of each."""
    if build.on_cpu(codes, table):
        return pack_rows_plain(codes, table, R=R, out=out)
    build.require(codes, torch.uint8, "codes")
    build.require(table, torch.int64, "table")
    if table.dim() != 2 or table.shape[1] != 3:
        raise ValueError(f"table must be (rows, 3), got {tuple(table.shape)}")
    if codes.numel() % CODE_ALIGN or codes.data_ptr() % CODE_ALIGN:
        raise ValueError(f"codes must be {CODE_ALIGN}-byte aligned and a multiple of "
                         f"{CODE_ALIGN} bytes long, got {codes.numel()}")
    if R < 1:
        raise ValueError(f"row width {R}")
    rows, dev = table.shape[0], codes.device
    RW, NW = row_words(R)
    if out is None:
        out = (torch.empty((rows, RW), dtype=torch.uint32, device=dev),
               torch.empty((rows, NW), dtype=torch.uint32, device=dev))
    packed, nmask = out
    for o, w, name in ((packed, RW, "packed"), (nmask, NW, "nmask")):
        build.require(o, torch.uint32, name)
        if tuple(o.shape) != (rows, w) or o.device != dev:
            raise ValueError(f"{name} must be ({rows}, {w}) on {dev}, got "
                             f"{tuple(o.shape)} on {o.device}")
    rc = build.lib().tp_upload_rows(
        codes.data_ptr(), codes.numel(), table.data_ptr(), rows, R,
        packed.data_ptr(), nmask.data_ptr(), build.stream_ptr(),
    )
    build.check(rc, "upload_rows")
    build.count_launch("upload_rows")
    return packed, nmask
