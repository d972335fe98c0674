"""Large host-buffer allocation.

First touch of numpy's default (private anonymous) pages is slow on
demand-faulted VMs, while SHARED anonymous mappings fault several times
faster. big_empty() returns an uninitialized numpy array backed by a
shared anonymous mmap for sizes where that matters, np.empty otherwise;
host_bytes() and host_empty() torch tensors on pages of their own,
whatever the size. pinned() page-locks such tensors only while copies to
or from a card run (an async copy then goes by DMA, with no bounce
buffer), so no buffer stays locked, or cached by PyTorch's page-locked
allocator, once the copies are done; host_copies() fetches a card's
tensors that way.
"""

from __future__ import annotations

import contextlib
import mmap

import numpy as np
import torch

from twopaco_tpu_torch import trace

_MMAP_MIN_BYTES = 64 << 20


def big_empty(shape, dtype) -> np.ndarray:
    """Uninitialized array; shared-anon-mmap-backed when large. The
    mapping lives exactly as long as the array (kept via .base)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    n = 1
    for s in shape:
        n *= int(s)
    dtype = np.dtype(dtype)
    n_bytes = n * dtype.itemsize
    if n_bytes < _MMAP_MIN_BYTES:
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, max(n_bytes, 1))
    return np.frombuffer(buf, dtype=dtype, count=n).reshape(shape)


def host_bytes(n: int) -> torch.Tensor:
    """Uninitialized (n,) uint8 host tensor that starts on a page and
    shares no page with other memory (so that pinned() locks nothing else
    with it: a copy from unlocked memory on a locked page fails): a view
    into numpy's memory two pages longer (numpy asks the kernel for huge
    pages on large blocks, and reuses freed small ones)."""
    page = mmap.PAGESIZE
    raw = np.empty(n + 2 * page, np.uint8)
    start = -raw.ctypes.data % page
    return torch.from_numpy(raw[start : start + n])


def host_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """host_bytes' memory as an uninitialized tensor of any dtype."""
    n = 1
    for s in shape:
        n *= int(s)
    if n == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return host_bytes(n * dtype.itemsize).view(dtype).reshape(tuple(shape))


def _page_spans(tensors) -> list[list[int]]:
    """The tensors' bytes as [start, end) runs of whole pages, overlapping
    runs merged (two tensors may share a page; a page is locked once)."""
    page = mmap.PAGESIZE
    ends = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
            for t in tensors if t.numel()]
    spans = sorted((a // page * page, -(-b // page) * page) for a, b in ends)
    out: list[list[int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


_locked: list[list[int]] = []  # the page runs pinned() holds locked now


@contextlib.contextmanager
def pinned(tensors, dev: torch.device):
    """Page-lock the host tensors (contiguous) for the copies to or from
    dev made inside the block; on leaving, wait for dev's current stream
    and unlock them. A no-op off a card. Whole pages are locked: inside
    the block, copy only from or to these tensors (host_bytes' memory
    shares its pages with nothing else). Pages that an enclosing block
    holds locked are left to it. Spans: `pin.lock` (attr bytes), `pin.wait`
    (the sync on leaving), `pin.unlock`."""
    if dev.type != "cuda":
        yield
        return
    rt = torch.cuda.cudart()
    done = []
    try:
        with trace.span("pin.lock") as sp:
            for run in _page_spans(tensors):
                if any(a <= run[0] and run[1] <= b for a, b in _locked):
                    continue
                torch.cuda.check_error(rt.cudaHostRegister(run[0], run[1] - run[0], 0))
                done.append(run)
                _locked.append(run)
            sp.attrs["bytes"] = sum(b - a for a, b in done)
        yield
    finally:
        with trace.span("pin.wait"):
            torch.cuda.current_stream(dev).synchronize()
        with trace.span("pin.unlock"):
            for run in done:
                _locked.remove(run)
                torch.cuda.check_error(rt.cudaHostUnregister(run[0]))


def host_copies(tensors):
    """CPU copies of tensors of one device: on a card, async copies into
    host_empty buffers page-locked for the copies (pinned) and one sync;
    CPU tensors as they are. Span `fetch.alloc` (the buffers)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return list(tensors)
    with trace.span("fetch.alloc"):
        out = [host_empty(t.shape, t.dtype) for t in tensors]
    with pinned(out, dev):
        for o, t in zip(out, tensors):
            o.copy_(t, non_blocking=True)
    return out
