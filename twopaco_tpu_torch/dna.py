"""DNA alphabet tables and host-side (numpy) 2-bit packing utilities.

Semantics follow the reference alphabet layer (dnachar.cpp:9-114):
  - definite chars  : "ACGT" -> codes 0,1,2,3
  - valid ambiguity : "ACGTURYKMSWBDHWNXV" -> code N (4)
  - anything else in a sequence body is an error
  - complement(code) = 3 - code  (A<->T, C<->G), N stays N

Packed k-mer layout (host and device alike): a k-char string packs into
w = ceil(k/16) uint32 words, char 0 in the *top* 2 bits of word 0
("left-aligned big-endian"), so lexicographic order of strings equals
lexicographic order of the word tuples.
"""

from __future__ import annotations

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4

LITERAL = "ACGT"
# reference: dnachar.cpp:11 (note 'W' appears twice there; set semantics)
VALID_CHARS = "ACGTURYKMSWBDHWNXV"

# byte -> code LUT: 0..3 ACGT, 4 ambiguous-valid, 254 whitespace, 255 invalid
ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _ws in b" \t\r\n\v\f":
    ENCODE_LUT[_ws] = 254
for _ch in VALID_CHARS:
    ENCODE_LUT[ord(_ch)] = CODE_N
    ENCODE_LUT[ord(_ch.lower())] = CODE_N
for _i, _ch in enumerate(LITERAL):
    ENCODE_LUT[ord(_ch)] = _i
    ENCODE_LUT[ord(_ch.lower())] = _i

DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an in-memory sequence to codes (no whitespace handling)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = ENCODE_LUT[raw]
    if codes.max(initial=0) >= 254:
        bad = raw[codes >= 254][0]
        raise ValueError(f"invalid character {chr(bad)!r} in sequence")
    return codes


def decode(codes: np.ndarray) -> str:
    return DECODE_LUT[np.minimum(codes, CODE_N)].tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    """3 - code for ACGT; N (and anything >= 4) maps to N."""
    return np.where(codes < 4, 3 - codes, CODE_N).astype(codes.dtype)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return complement(codes[::-1])


def revcomp_str(s: str) -> str:
    return decode(revcomp(encode(s)))


def n_words(k: int) -> int:
    """Number of uint32 words holding a k-char packed string."""
    return (k + 15) // 16


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Pack rows of codes (n, k) uint8 (values 0..3) into (n, w) uint32.

    Left-aligned: char j lives in word j//16 at bit offset 30 - 2*(j%16).
    """
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[None, :]
    n, kk = codes.shape
    if kk != k:
        raise ValueError(f"expected {k} chars per row, got {kk}")
    out = np.zeros((n, n_words(k)), dtype=np.uint32)
    c = codes.astype(np.uint32)
    for j in range(k):
        out[:, j // 16] |= c[:, j] << np.uint32(30 - 2 * (j % 16))
    return out


def pack_kmer_str(s: str) -> np.ndarray:
    """Pack a single all-definite k-mer string -> (w,) uint32."""
    codes = encode(s)
    if codes.max(initial=0) >= 4:
        raise ValueError("k-mer must be over ACGT only")
    return pack_kmers(codes[None, :], len(codes))[0]


def words_to_bytes_keys(words: np.ndarray) -> np.ndarray:
    """View (n, w) uint32 rows as fixed-width big-endian byte strings.

    numpy byte-string comparison is lexicographic on bytes, which matches
    word-tuple order, enabling np.searchsorted over multi-word keys.
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    be = words.astype(">u4")
    n, w = be.shape
    return np.ascontiguousarray(be).view(f"S{4 * w}").reshape(n)
