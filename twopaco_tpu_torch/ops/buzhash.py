"""Strand-symmetric Buzhash window hashes, plain PyTorch.

The same hash family as twopaco_tpu.ops.buzhash, for every position at
once from prefix-XOR scans:

    H(p, n)    = XOR_{j=0..n-1} rotl(T[c_{p+j}], n-1-j)        (forward)
    G[i]       = rotr(T[c_i], i mod 32)
    S          = exclusive prefix-XOR of G
    H(p, n)    = rotl(S[p+n] ^ S[p], (p+n-1) mod 32)

    H'(p, n)   = hash of the reverse complement of the window
               = XOR_{j=0..n-1} rotl(T[3-c_{p+j}], j)
    G'[i]      = rotl(T[3-c_i], i mod 32)
    S'         = exclusive prefix-XOR of G'
    H'(p, n)   = rotr(S'[p+n] ^ S'[p], p mod 32)

The vertex hash h(W) + h'(W) mod 2^32 is the same for both strands. Math
is on int64 tensors holding u32 values (see ops/pack.py).
"""

from __future__ import annotations

import numpy as np
import torch

from twopaco_tpu_torch.ops.pack import MASK32

# The four char tables: the same numpy draw as the JAX package
# (PCG64 seed 20160815), so both packages hash identically.
_T = np.random.Generator(np.random.PCG64(20160815)).integers(
    0, 1 << 32, size=(4, 4), dtype=np.uint32
)
TABLE_1 = tuple(int(x) for x in _T[0])
TABLE_2 = tuple(int(x) for x in _T[1])
TABLE_3 = tuple(int(x) for x in _T[2])
TABLE_4 = tuple(int(x) for x in _T[3])


def rotl(x: torch.Tensor, s) -> torch.Tensor:
    s = s & 31
    return ((x << s) & MASK32) | (x >> ((32 - s) & 31))


def rotr(x: torch.Tensor, s) -> torch.Tensor:
    s = s & 31
    return (x >> s) | ((x << ((32 - s) & 31)) & MASK32)


def _lookup(codes: torch.Tensor, table) -> torch.Tensor:
    """T[c & 3] (N = 4 reads T[0], as in the JAX package)."""
    t = torch.tensor(table, dtype=torch.int64, device=codes.device)
    return t[codes.to(torch.int64) & 3]


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR along the last axis (log-step doubling)."""
    s = 1
    while s < x.shape[-1]:
        shifted = torch.zeros_like(x)
        shifted[..., s:] = x[..., :-s]
        x = x ^ shifted
        s *= 2
    return x


def hash_scans(codes: torch.Tensor, table) -> tuple[torch.Tensor, torch.Tensor]:
    """codes (..., L) -> (S, S') exclusive prefix-XOR scans (..., L+1)."""
    L = codes.shape[-1]
    i = torch.arange(L, device=codes.device)
    g_f = rotr(_lookup(codes, table), i)
    g_r = rotl(_lookup(3 - (codes.to(torch.int64) & 3), table), i)
    zero = torch.zeros(codes.shape[:-1] + (1,), dtype=torch.int64, device=codes.device)
    return (
        torch.cat([zero, _prefix_xor(g_f)], dim=-1),
        torch.cat([zero, _prefix_xor(g_r)], dim=-1),
    )


def window_hashes(s_f, s_r, n: int, n_out: int):
    """Forward and RC-strand hashes of n-char windows at offsets
    0..n_out-1: -> (hf, hr) each (..., n_out) int64 u32 values."""
    p = torch.arange(n_out, device=s_f.device)
    d_f = s_f[..., n : n + n_out] ^ s_f[..., :n_out]
    d_r = s_r[..., n : n + n_out] ^ s_r[..., :n_out]
    return rotl(d_f, p + (n - 1)), rotr(d_r, p)
