"""Large host-buffer allocation.

First touch of numpy's default (private anonymous) pages is slow on
demand-faulted VMs, while SHARED anonymous mappings fault several times
faster. big_empty() returns an uninitialized numpy array backed by a
shared anonymous mmap for sizes where that matters, np.empty otherwise.
"""

from __future__ import annotations

import mmap

import numpy as np

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
