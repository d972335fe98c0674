"""Deterministic synthetic pangenome for benchmarking.

Mirrors the reference's paper workload shape (many closely related
genomes): one random base sequence plus mutated copies (substitutions +
sparse N runs), generated with vectorized numpy so 100s of Mbases are
cheap. Same generator and seed as twopaco_tpu.testing.bench_data, so both
packages see the same bytes.
"""

from __future__ import annotations

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_bench_genomes(
    n_seqs: int = 8,
    length: int = 8_000_000,
    snp_rate: float = 0.01,
    n_rate: float = 1e-4,
    seed: int = 2016,
) -> list[np.ndarray]:
    """Returns byte arrays (ASCII) of the sequences."""
    rng = np.random.default_rng(seed)
    base = _ALPHA[rng.integers(0, 4, size=length)]
    seqs = [base]
    for _ in range(1, n_seqs):
        s = base.copy()
        flip = rng.random(length) < snp_rate
        s[flip] = _ALPHA[rng.integers(0, 4, size=int(flip.sum()))]
        ns = rng.random(length) < n_rate
        s[ns] = ord("N")
        seqs.append(s)
    return seqs


def write_bench_fasta(
    path: str, n_seqs: int = 8, length: int = 8_000_000, seed: int = 2016
) -> str:
    """Write the benchmark FASTA (one line per record); returns the path."""
    seqs = make_bench_genomes(n_seqs=n_seqs, length=length, seed=seed)
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(f">g{i}\n".encode())
            f.write(s.tobytes())
            f.write(b"\n")
    return path
