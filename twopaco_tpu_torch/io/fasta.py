"""Vectorized FASTA reader with reference-identical validation semantics.

Matches the reference parser (streamfastaparser.cpp:29-93):
  - a record header is the first whitespace-delimited token after '>';
  - whitespace inside sequence bodies is skipped;
  - characters are uppercased, then validated against
    "ACGTURYKMSWBDHWNXV"; anything else raises;
  - non-ACGT valid characters are kept as the ambiguity code N.

Parsing is a handful of numpy passes over the whole buffer (LUT gather +
boolean compaction).
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from twopaco_tpu_torch import dna


class FastaError(RuntimeError):
    pass


def _parse_buffer(buf: np.ndarray, path: str) -> Iterator[tuple[str, np.ndarray]]:
    for s, hdr_end, e in _record_spans(buf, path):
        header_line = buf[s + 1 : hdr_end].tobytes().decode("latin-1")
        header = header_line.split()[0] if header_line.split() else ""
        body = buf[hdr_end + 1 : e] if hdr_end < e else buf[:0]
        codes = dna.ENCODE_LUT[body]
        if codes.size and codes.max() == 255:
            bad = body[codes == 255][0]
            raise FastaError(
                f"{path}: found an invalid character {chr(bad)!r} "
                f"in sequence {header}"
            )
        codes = codes[codes != 254]  # drop whitespace
        yield header, codes


def read_fasta(path: str | os.PathLike) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (header, codes uint8[0..4]) per record, in file order."""
    buf = np.fromfile(os.fspath(path), dtype=np.uint8)
    yield from _parse_buffer(buf, os.fspath(path))


def read_all_records(
    paths: Iterable[str | os.PathLike],
) -> Iterator[tuple[int, str, np.ndarray]]:
    """Stream (seq_id, header, codes) across multiple files, reference
    ChrReader order (streamfastaparser.h:140-182): files in CLI order,
    records in file order, seq_id global and 0-based."""
    seq_id = 0
    for path in paths:
        for header, codes in read_fasta(path):
            yield seq_id, header, codes
            seq_id += 1


def _record_spans(buf: np.ndarray, path: str):
    """Yield (record_start, header_line_end, record_end) index triples.

    Reference semantics: ANY '>' in a body — even mid-line — starts the
    next record (GetChar ends the body on '>' unconditionally,
    streamfastaparser.cpp:73-77), while a '>' inside a header line is
    plain header text (ReadRecord consumes the whole line, :44-55).
    """
    if buf.size == 0:
        return
    if buf[0] != ord(">"):
        raise FastaError(f"{path}: the FASTA header should start with a '>'")
    gts = np.flatnonzero(buf == ord(">"))
    newlines = np.flatnonzero(buf == ord("\n"))
    spans = []
    i = 0
    while i < gts.size:
        s = int(gts[i])
        j = np.searchsorted(newlines, s)
        hdr_end = int(newlines[j]) if j < newlines.size else buf.size
        i = int(np.searchsorted(gts, hdr_end))
        spans.append((s, hdr_end))
    for idx, (s, hdr_end) in enumerate(spans):
        e = spans[idx + 1][0] if idx + 1 < len(spans) else buf.size
        yield s, hdr_end, e
