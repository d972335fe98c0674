"""Binary junction-position list: reference-identical 12-byte records.

Format (reference junctionapi.h:107-137): a flat stream of little-endian
records ``uint32 pos`` + ``int64 id``. Chromosome ids are implicit: a
separator record (pos=0xFFFFFFFF, id=INT64_MAX) is written once per
chromosome increment; the reader infers the chromosome by counting
separators.
"""

from __future__ import annotations

import os
import time

import numpy as np

from twopaco_tpu_torch.io import native

SEPARATOR_POS = np.uint32(0xFFFFFFFF)
SEPARATOR_ID = np.int64((1 << 63) - 1)

RECORD_DTYPE = np.dtype([("pos", "<u4"), ("id", "<i8")], align=False)
assert RECORD_DTYPE.itemsize == 12


class ChunkWriter:
    """Vectorized streaming writer for (chr, pos, id) chunks in stream
    order: separator records are spliced at chromosome increments
    (including skipped chromosomes), with the chromosome counter carried
    across chunks (the reference's JunctionPositionWriter,
    junctionapi.h:118-132). The native emit (io/native.py) assembles a
    chunk when it is available, the numpy body below otherwise;
    counters() says where its time went."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._now_chr = 0
        self._scratch = None  # the native emit's buffer, reused chunk to chunk
        self._write_ns = self._sink_ns = self._close_ns = self._bytes = 0
        sep = np.empty(1, dtype=RECORD_DTYPE)
        sep["pos"] = SEPARATOR_POS
        sep["id"] = SEPARATOR_ID
        self._sep = sep.tobytes()

    def _put(self, data) -> None:
        t0 = time.perf_counter_ns()
        self._f.write(data)
        self._sink_ns += time.perf_counter_ns() - t0
        self._bytes += memoryview(data).nbytes

    def write(self, chrs: np.ndarray, pos: np.ndarray, ids: np.ndarray):
        t0 = time.perf_counter_ns()
        self._write(chrs, pos, ids)
        self._write_ns += time.perf_counter_ns() - t0

    def write_raw(self, data) -> None:
        """Finished records, separators in place, as they are (the card
        emit's chunks, passes/emit.py); the chromosome counter is left
        alone."""
        t0 = time.perf_counter_ns()
        self._put(data)
        self._write_ns += time.perf_counter_ns() - t0

    def _write(self, chrs: np.ndarray, pos: np.ndarray, ids: np.ndarray):
        n = len(chrs)
        if n == 0:
            return
        chrs = np.ascontiguousarray(chrs, np.int64)
        buf = native.emit_records(
            chrs,
            np.ascontiguousarray(pos, np.uint32),
            np.ascontiguousarray(ids, np.int64),
            self._now_chr,
            scratch=self._scratch,
        )
        if buf is not None:
            self._scratch = buf.base if buf.base is not None else buf
            self._put(buf.data)
            self._now_chr = int(chrs[-1])
            return
        scratch = np.empty((n, 3), np.uint32)
        scratch[:, 0] = pos
        scratch[:, 1:] = (
            np.ascontiguousarray(ids, np.int64).view(np.uint32).reshape(n, 2)
        )
        rec = scratch.reshape(-1).view(np.uint8).reshape(n, 12)
        prev = np.empty(n, np.int64)
        prev[0] = self._now_chr
        prev[1:] = chrs[:-1]
        start = 0
        for i in np.flatnonzero(chrs != prev):
            self._put(rec[start:i].data)
            self._put(self._sep * int(chrs[i] - prev[i]))
            start = int(i)
        self._put(rec[start:].data)
        self._now_chr = int(chrs[-1])

    def close(self) -> None:
        t0 = time.perf_counter_ns()
        self._f.close()  # the buffered tail goes to the file here
        self._close_ns = time.perf_counter_ns() - t0

    def counters(self) -> dict:
        """Once closed: the seconds spent in the file's writes and its
        close (sink_s), the rest of the write calls (assemble_s: the
        records' assembly), and the bytes written."""
        return dict(assemble_s=(self._write_ns - self._sink_ns) / 1e9,
                    sink_s=(self._sink_ns + self._close_ns) / 1e9, bytes=self._bytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_junctions(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read the whole file -> (chr int32, pos uint32, id int64) arrays
    (JunctionPositionReader::NextJunctionPosition, junctionapi.h:81-99):
    separators bump the chromosome counter and are not returned."""
    size = os.path.getsize(path)
    if size % RECORD_DTYPE.itemsize != 0:
        raise RuntimeError(
            f"{path}: size {size} is not a multiple of the 12-byte "
            "junction record — truncated or not a twopaco binary"
        )
    rec = np.fromfile(path, dtype=RECORD_DTYPE)
    is_sep = (rec["pos"] == SEPARATOR_POS) & (rec["id"] == SEPARATOR_ID)
    chrs = np.cumsum(is_sep.astype(np.int32)) - is_sep.astype(np.int32)
    keep = ~is_sep
    return chrs[keep].astype(np.int32), rec["pos"][keep], rec["id"][keep]
