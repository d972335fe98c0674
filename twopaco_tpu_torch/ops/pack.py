"""2-bit k-mer packing and reverse complement, plain PyTorch.

The same functions as twopaco_tpu.ops.pack, written for torch tensors.
PyTorch's CPU build has no uint32 shifts, adds or compares, so every
function here computes on int64 tensors holding u32 values and masks
with `& 0xFFFFFFFF` after each left shift. `as_i64` / `as_u32` convert
between the uint32 storage the kernels use and that working form.

Layout matches twopaco_tpu_torch.dna.pack_kmers: w = ceil(k/16) uint32
words, char 0 in the top 2 bits of word 0, left-aligned; lexicographic
order on word tuples equals string order.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def as_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 tensor of the same values."""
    return x.view(torch.int32).to(torch.int64) & MASK32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> uint32 tensor."""
    return x.to(torch.int32).view(torch.uint32)


def take_u32(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] for a uint32 tensor, through an int32 view (CUDA's
    indexing kernels do not take uint32)."""
    return x.view(torch.int32)[index].view(torch.uint32)


def n_words(k: int) -> int:
    return (k + 15) // 16


def last_word_mask(k: int) -> int:
    """Mask of the char bits in the last word (top 2r bits, r = chars)."""
    r = k - 16 * (n_words(k) - 1)
    return MASK32 if r == 16 else (MASK32 << (32 - 2 * r)) & MASK32


def _shift_slice(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[..., i] -> x[..., i+n], zero-padded at the tail."""
    if n == 0:
        return x
    out = torch.zeros_like(x)
    out[..., : x.shape[-1] - n] = x[..., n:]
    return out


def pack16(codes: torch.Tensor) -> torch.Tensor:
    """codes (..., L) int64 in [0, 3] -> (..., L) where entry i holds
    chars i..i+15 left-aligned (chars past L read as 0)."""
    p = codes << 30
    for step, shift in ((1, 2), (2, 4), (4, 8), (8, 16)):
        p = p | (_shift_slice(p, step) >> shift)
    return p


def kmer_words(codes: torch.Tensor, k: int, n_out: int) -> torch.Tensor:
    """Packed k-mers at char offsets 0..n_out-1.

    codes: (..., L) int64 in [0, 3] (N masked to 0 beforehand).
    Returns (..., n_out, w) int64; word m of offset j = chars j+16m ...
    """
    w = n_words(k)
    need = n_out + 16 * w
    L = codes.shape[-1]
    if L < need:
        codes = torch.nn.functional.pad(codes, (0, need - L))
    p16 = pack16(codes)
    words = [_shift_slice(p16, 16 * m)[..., :n_out] for m in range(w)]
    words[-1] = words[-1] & last_word_mask(k)
    return torch.stack(words, dim=-1)


def bitrev2_32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each u32 value."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & MASK32


def revcomp_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (..., w) -> (..., w): a
    2-bit-group reversal of the whole 32w-bit field, a left realignment
    by 32w - 2k bits, and an XOR of the char bits (comp(c) = c ^ 3)."""
    w = n_words(k)
    s = 32 * w - 2 * k  # 0 <= s < 32
    b = [bitrev2_32(words[..., w - 1 - m]) for m in range(w)]
    if s:
        b = [
            ((b[m] << s) & MASK32) | (b[m + 1] >> (32 - s))
            for m in range(w - 1)
        ] + [(b[w - 1] << s) & MASK32]
    out = [x ^ MASK32 for x in b[:-1]] + [b[-1] ^ last_word_mask(k)]
    return torch.stack(out, dim=-1)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (word) axis -> bool (...)."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for m in range(a.shape[-1]):
        am, bm = a[..., m], b[..., m]
        lt = lt | (eq & (am < bm))
        eq = eq & (am == bm)
    return lt


def canonical(words: torch.Tensor, rcwords: torch.Tensor):
    """-> (canon (..., w), is_rc bool (...)): lexicographic min of the
    two strands (strict for odd k: no odd-length 2-bit palindromes)."""
    is_rc = lex_less(rcwords, words)
    return torch.where(is_rc[..., None], rcwords, words), is_rc


def pack_codes_host(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, R) uint8 host codes (0..4, 4 = N/pad) -> (packed (B,
    ceil(R/16)) uint32 2-bit chars little-first, nmask (B, ceil(R/32))
    uint32 bitmask of N chars). The device's upload form: 2.25 bits a
    char instead of 8."""
    B, R = codes.shape
    RW = (R + 15) // 16
    c = np.zeros((B, RW * 16), np.uint32)
    c[:, :R] = codes
    isn = c >= 4
    two = np.where(isn, 0, c).reshape(B, RW, 16)
    sh = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    packed = np.bitwise_or.reduce(two << sh, axis=2).astype(np.uint32)
    NW = (R + 31) // 32
    nb = np.zeros((B, NW * 32), bool)
    nb[:, :R] = isn[:, :R]
    nmask = np.ascontiguousarray(
        np.packbits(nb.reshape(B, NW, 32), axis=2, bitorder="little")
    ).view(np.uint32)[..., 0]
    return packed, nmask


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor, R: int) -> torch.Tensor:
    """Inverse of pack_codes_host: uint32 (packed, nmask) -> (B, R)
    uint8 codes."""
    B = packed.shape[0]
    sh = torch.arange(16, device=packed.device) * 2
    codes = ((as_i64(packed)[:, :, None] >> sh) & 3).reshape(B, -1)[:, :R]
    bit = torch.arange(32, device=packed.device)
    isn = ((as_i64(nmask)[:, :, None] >> bit) & 1).reshape(B, -1)[:, :R]
    return torch.where(isn > 0, 4, codes).to(torch.uint8)


def window_all_definite(codes: torch.Tensor, k: int, n_out: int) -> torch.Tensor:
    """True where chars [j, j+k) are all < 4 (ACGT), for j in 0..n_out-1;
    chars past the end count as N. codes: (..., L) integer."""
    bad = (codes >= 4).to(torch.int64)
    zero = torch.zeros(codes.shape[:-1] + (1,), dtype=torch.int64, device=codes.device)
    cs0 = torch.cat([zero, torch.cumsum(bad, dim=-1)], dim=-1)
    need = n_out + k
    L = codes.shape[-1]
    if L < need:
        tail = cs0[..., -1:] + torch.arange(1, need - L + 1, device=codes.device)
        cs0 = torch.cat([cs0, tail], dim=-1)
    return (cs0[..., k : k + n_out] - cs0[..., :n_out]) == 0
