"""Exact naive junction oracle (numpy port of the reference self-test).

Semantics from FindJunctionsNaively (test.cpp:71-160):
  - every non-ACGT char and every sequence boundary becomes a globally
    unique virtual symbol (so such extensions never coincide);
  - both strands of every sequence are walked; for each all-definite
    k-mer the sets of in/out extension symbols are collected;
  - a junction is a k-mer with >1 distinct in-extensions or >1 distinct
    out-extensions; its reverse complement is also a junction;
  - additionally position 0 and position L-k of every sequence are
    always marked (stub endpoints).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from twopaco_tpu_torch import dna


def find_junctions_naively(
    seqs: list[str], k: int
) -> tuple[set[str], list[np.ndarray]]:
    """-> (junction k-mer strings, per-sequence position marks)."""
    unknown = [10**9]  # virtual symbol counter (as in test.cpp:73)

    def fresh() -> int:
        unknown[0] += 1
        return unknown[0]

    genomes: list[list] = []
    for s in seqs:
        g: list = [fresh()]
        for ch in s:
            g.append(ch if ch in "ACGT" else fresh())
        g.append(fresh())
        genomes.append(g)
        rev: list = []
        for ch in reversed(g):
            if isinstance(ch, str) and ch in "ACGT":
                rev.append("TGCA"["ACGT".index(ch)])
            else:
                rev.append(fresh())
        genomes.append(rev)

    in_edge: dict[str, set] = defaultdict(set)
    out_edge: dict[str, set] = defaultdict(set)
    for g in genomes:
        n = len(g)
        if n < k:
            continue
        for i in range(n - k + 1):
            window = g[i : i + k]
            if all(isinstance(c, str) for c in window):
                vertex = "".join(window)
                if i + k < n:
                    out_edge[vertex].add(g[i + k])
                if i > 0:
                    in_edge[vertex].add(g[i - 1])

    junction: set[str] = set()
    for edges in (in_edge, out_edge):
        for vertex, ext in edges.items():
            if len(ext) > 1:
                junction.add(vertex)
                junction.add(dna.revcomp_str(vertex))

    marks = []
    for s in seqs:
        m = np.zeros(len(s), dtype=bool)
        if len(s) >= k:
            m[0] = True
            m[len(s) - k] = True
            for pos in range(len(s) - k + 1):
                if s[pos : pos + k] in junction:
                    m[pos] = True
        marks.append(m)
    return junction, marks


def generate_sequence(rng: np.random.Generator, length: int, n_rate: float = 1 / 500) -> str:
    """Random test fixture (reference GenerateSequence, test.cpp:20-37)."""
    chars = rng.integers(0, 4, size=length)
    s = np.frombuffer(b"ACGT", dtype=np.uint8)[chars]
    ns = rng.random(length) < n_rate
    s = np.where(ns, ord("N"), s).astype(np.uint8)
    return s.tobytes().decode()


def mutate_sequence(
    rng: np.random.Generator, chr_: str, change_rate: float, indel_rate: float
) -> str:
    """SNPs + insertions (reference MutateSequence, test.cpp:39-67)."""
    out = []
    alphabet = "ACGT"
    for ch in chr_:
        if rng.random() <= change_rate:
            if rng.random() <= indel_rate:
                out.append(alphabet[rng.integers(0, 4)])  # substitution
            else:
                if rng.random() <= 0.5:
                    out.append(ch)
                    out.append(alphabet[rng.integers(0, 4)])  # insertion
                # else: deletion (drop the char)
        else:
            out.append(ch)
    return "".join(out)
