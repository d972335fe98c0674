"""ctypes bridge to the port's native FASTA encoder and record emit
(twopaco_tpu_torch/native/fastaio.cpp).

The library is built with g++ at first use (native/__init__.py build,
into native/build/). Readers and writers take the numpy path when no
compiler is found, when the build fails, or when TWOPACO_NATIVE=0 is set
(read at each call); status() says which. This is host code: a parse
error from the native encoder is an error, never a retry in numpy.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from twopaco_tpu_torch import native as native_build
from twopaco_tpu_torch.hostmem import big_empty

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


class _TpFastaResult(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("codes_len", ctypes.c_int64),
        ("rec_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_records", ctypes.c_int64),
        ("headers", ctypes.POINTER(ctypes.c_char)),
        ("headers_len", ctypes.c_int64),
        ("header_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char * 256),
    ]


_SIGNATURES = {
    "tp_encode_fasta_into": (
        [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
         ctypes.POINTER(_TpFastaResult)],
        ctypes.c_int,
    ),
    "tp_free_result": ([ctypes.POINTER(_TpFastaResult)], None),
    "tp_emit_records": (
        [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
         ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
         ctypes.POINTER(ctypes.c_uint8)],
        ctypes.c_int64,
    ),
}


class NativeLibrary:
    """fastaio.cpp's library, built and loaded at the first get(); a
    build that failed is not tried again by this object."""

    def __init__(self, build_dir=native_build.BUILD_DIR):
        self.build_dir = build_dir
        self.path = None
        self._lib = None
        self._error = None
        self._lock = threading.Lock()

    def get(self):
        """The loaded library, or None (TWOPACO_NATIVE=0, no compiler, a
        failed build or load)."""
        if os.environ.get("TWOPACO_NATIVE", "1") == "0":
            return None
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self.path = native_build.build(
                        "fastaio.cpp", "libtwopaco_io", ("g++", "c++"), CXX_FLAGS,
                        suffix=".so", build_dir=self.build_dir)
                    lib = ctypes.CDLL(str(self.path))
                except (native_build.HostBuildError, OSError) as e:
                    self._error = str(e)
                    return None
                for name, (args, res) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = res
                self._lib = lib
            return self._lib

    def status(self) -> str:
        """Why the readers take the path they take (after a get())."""
        if os.environ.get("TWOPACO_NATIVE", "1") == "0":
            return "disabled (TWOPACO_NATIVE=0)"
        if self._lib is not None:
            return f"loaded {self.path}"
        if self._error is not None:
            return f"unavailable: {self._error}"
        return "not loaded yet"


LIBRARY = NativeLibrary()


def available() -> bool:
    return LIBRARY.get() is not None


def status() -> str:
    return LIBRARY.status()


def emit_records(
    chrs: np.ndarray,
    pos: np.ndarray,
    ids: np.ndarray,
    now_chr: int,
    scratch: np.ndarray | None = None,
) -> np.ndarray | None:
    """Assemble one chunk of 12-byte junction records (+ separators at
    chromosome increments) in one native pass; None if unavailable.
    chrs int64 / pos uint32 / ids int64, all C-contiguous, same length,
    at least one record. `scratch` (uint8) is reused when big enough:
    callers in a write loop pass the previous return's `.base`."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    n = len(chrs)
    if not (len(pos) == len(ids) == n > 0):
        raise ValueError(f"emit_records: lengths {len(chrs)}, {len(pos)}, {len(ids)}")
    for a, dt in ((chrs, np.int64), (pos, np.uint32), (ids, np.int64)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError(f"emit_records: want C-contiguous {np.dtype(dt)}, got {a.dtype}")
    need = 12 * (n + max(int(chrs[-1]) - now_chr, 0))
    if scratch is None or scratch.size < need:
        scratch = big_empty(need, np.uint8)
    written = lib.tp_emit_records(
        chrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        now_chr,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return scratch[:written]


def encode_fasta_native(path, out: np.ndarray | None = None
                        ) -> list[tuple[str, np.ndarray]] | None:
    """Parse and encode one FASTA natively; None if unavailable.

    Returns [(header, codes uint8)] like the numpy parser, the codes views
    of one buffer: `out` (uint8, written from its start; the file's size
    always suffices), else a new one of the file's size. Raises
    RuntimeError on invalid input (the reference's conditions), a file
    that cannot be read, or codes that do not fit `out`."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    path = os.fspath(path)
    try:
        size = os.path.getsize(path)
    except OSError:
        raise RuntimeError(f"Can't open file {path}") from None
    if out is not None and (out.dtype != np.uint8 or not out.flags.c_contiguous):
        raise ValueError(f"encode_fasta_native: want a C-contiguous uint8 out, got {out.dtype}")
    codes = big_empty(max(size, 1), np.uint8) if out is None else out
    cap = codes.size
    res = _TpFastaResult()
    rc = lib.tp_encode_fasta_into(
        path.encode(),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
        ctypes.byref(res),
    )
    if rc != 0:
        msg = res.error.decode(errors="replace")
        raise RuntimeError(msg or f"native FASTA parse failed ({rc})")
    try:
        n = res.n_records
        offs = np.ctypeslib.as_array(res.rec_offsets, shape=(n + 1,)).tolist()
        hoffs = np.ctypeslib.as_array(res.header_offsets, shape=(n + 1,)).tolist()
        raw = ctypes.string_at(res.headers, res.headers_len)
        return [(raw[hoffs[i]:hoffs[i + 1]].decode("latin-1"), codes[offs[i]:offs[i + 1]])
                for i in range(n)]
    finally:
        lib.tp_free_result(ctypes.byref(res))
