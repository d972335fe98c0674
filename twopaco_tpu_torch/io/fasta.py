"""Vectorized FASTA reader with reference-identical validation semantics.

Matches the reference parser (streamfastaparser.cpp:29-93):
  - a record header is the first whitespace-delimited token after '>';
  - whitespace inside sequence bodies is skipped;
  - characters are uppercased, then validated against
    "ACGTURYKMSWBDHWNXV"; anything else raises;
  - non-ACGT valid characters are kept as the ambiguity code N.

Parsing is a handful of numpy passes over the whole buffer (LUT gather +
boolean compaction); read_fasta takes the native encoder
(twopaco_tpu_torch/native/fastaio.cpp) first. read_all_staged puts every
record's codes in one buffer, the form the card's upload reads.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.hostmem import host_bytes


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
    """Yield (header, codes uint8[0..4]) per record, in file order.

    Uses the native C++ encoder (io/native.py) when it is available, else
    the numpy parser; a native parse error raises FastaError."""
    from twopaco_tpu_torch.io import native

    if native.available():
        try:
            recs = native.encode_fasta_native(path)
        except RuntimeError as e:
            raise FastaError(str(e)) from None
        if recs is not None:
            yield from recs
            return
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


STAGE_ALIGN = 16  # a staged buffer's length is a multiple of this (upload.cu's loads)


def _padded(n: int) -> int:
    return -(-n // STAGE_ALIGN) * STAGE_ALIGN


def stage_codes(codes):
    """The codes arrays copied back to back into one host buffer
    (hostmem.host_bytes), padded to STAGE_ALIGN
    bytes: the form the card's upload reads (io/windows.py window_rows
    gives the rows' spans in it)."""
    buf = host_bytes(_padded(sum(len(c) for c in codes)))
    out = buf.numpy()
    ofs = 0
    for c in codes:
        out[ofs : ofs + len(c)] = c
        ofs += len(c)
    return buf


def read_all_staged(paths: Iterable[str | os.PathLike]):
    """read_all_records' sequences and stage_codes' buffer of their codes.
    The native encoder writes the codes straight into the buffer (sized by
    the files) and the sequences are views of it; the numpy parser's codes
    are copied in.

    -> ([(seq_id, codes)], the buffer)"""
    from twopaco_tpu_torch.io import native

    paths = [os.fspath(p) for p in paths]
    if not native.available():
        recs = [c for _sid, _h, c in read_all_records(paths)]
        return list(enumerate(recs)), stage_codes(recs)
    try:
        size = sum(os.path.getsize(p) for p in paths)
    except OSError as e:
        raise FastaError(f"Can't open file {e.filename}") from None
    buf = host_bytes(size + STAGE_ALIGN)
    out = buf.numpy()
    recs, used = [], 0
    for path in paths:
        try:
            got = native.encode_fasta_native(path, out[used:])
        except RuntimeError as e:
            raise FastaError(str(e)) from None
        if got is None:  # unloaded since available(): not expected
            raise FastaError(f"native encoder unavailable: {native.status()}")
        recs.extend(c for _h, c in got)
        used += sum(len(c) for _h, c in got)
    return list(enumerate(recs)), buf[: _padded(used)]


# byte -> uppercased byte, 0 for whitespace (drop), 255 for invalid
_UPPER_LUT = np.full(256, 255, dtype=np.uint8)
for _ws in b" \t\r\n\v\f":
    _UPPER_LUT[_ws] = 0
for _ch in dna.VALID_CHARS:
    _UPPER_LUT[ord(_ch)] = ord(_ch)
    _UPPER_LUT[ord(_ch.lower())] = ord(_ch)


def read_sequences_text(paths: Iterable[str | os.PathLike]) -> Iterator[str]:
    """Yield validated, uppercased sequence text per record, keeping the
    ambiguity letters (graphdump spells segment bodies from this text; the
    reference's ChrReader, streamfastaparser.h:151, keeps e.g. 'Y' as
    'Y')."""
    for path in paths:
        buf = np.fromfile(os.fspath(path), dtype=np.uint8)
        for _s, hdr_end, e in _record_spans(buf, os.fspath(path)):
            body = buf[hdr_end + 1 : e] if hdr_end < e else buf[:0]
            up = _UPPER_LUT[body]
            if up.size and up.max() == 255:
                bad = body[up == 255][0]
                raise FastaError(
                    f"{os.fspath(path)}: found an invalid character {chr(bad)!r}"
                )
            yield up[up != 0].tobytes().decode("latin-1")


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
