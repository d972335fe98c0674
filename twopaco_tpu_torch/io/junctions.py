"""Binary junction-position list: reference-identical 12-byte records.

Format (reference junctionapi.h:107-137): a flat stream of little-endian
records ``uint32 pos`` + ``int64 id``. Chromosome ids are implicit: a
separator record (pos=0xFFFFFFFF, id=INT64_MAX) is written once per
chromosome increment; the reader infers the chromosome by counting
separators.
"""

from __future__ import annotations

import os

import numpy as np

SEPARATOR_POS = np.uint32(0xFFFFFFFF)
SEPARATOR_ID = np.int64((1 << 63) - 1)

RECORD_DTYPE = np.dtype([("pos", "<u4"), ("id", "<i8")], align=False)
assert RECORD_DTYPE.itemsize == 12


class ChunkWriter:
    """Vectorized streaming writer for (chr, pos, id) chunks in stream
    order: separator records are spliced at chromosome increments
    (including skipped chromosomes), with the chromosome counter carried
    across chunks (the reference's JunctionPositionWriter,
    junctionapi.h:118-132)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._now_chr = 0
        sep = np.empty(1, dtype=RECORD_DTYPE)
        sep["pos"] = SEPARATOR_POS
        sep["id"] = SEPARATOR_ID
        self._sep = sep.tobytes()

    def write(self, chrs: np.ndarray, pos: np.ndarray, ids: np.ndarray):
        n = len(chrs)
        if n == 0:
            return
        chrs = np.ascontiguousarray(chrs, np.int64)
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
            self._f.write(rec[start:i].data)
            self._f.write(self._sep * int(chrs[i] - prev[i]))
            start = int(i)
        self._f.write(rec[start:].data)
        self._now_chr = int(chrs[-1])

    def close(self) -> None:
        self._f.close()

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
