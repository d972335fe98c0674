"""The synthetic pangenome the cells build, generated from a seed.

A frozen copy of twopaco_tpu_torch/testing/bench_data.py's generator (the
same bytes for the same arguments): one uniform random base genome and
n - 1 copies of it, each with independent substitutions and N runs. The
benchmark keeps its own copy so that a change to the program's testing
helpers cannot change what the benchmark feeds the program.
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


def rng_seed(seed: int) -> int:
    """The generator's seed for a benchmark --seed: any whole number,
    taken modulo 2^64 (numpy takes non-negative seeds; the ones below
    2^63 pass unchanged)."""
    return seed % (1 << 64)


def config_genomes(config: dict, seed: int) -> list[np.ndarray]:
    """The sequences of a configuration file's sizes for --seed."""
    return make_bench_genomes(
        n_seqs=int(config["genomes"]), length=int(config["length"]),
        snp_rate=float(config["snp_rate"]), n_rate=float(config["n_rate"]),
        seed=rng_seed(seed),
    )


def write_fasta(path: str, seqs: list[np.ndarray]) -> int:
    """Write the sequences as FASTA, one line a record (headers g0, g1,
    ...); returns the number of bases."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(f">g{i}\n".encode())
            f.write(memoryview(s))
            f.write(b"\n")
    return int(sum(len(s) for s in seqs))
