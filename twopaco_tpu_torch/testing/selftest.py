"""Randomized differential self test of the port (reference RunTests,
test.cpp:163), the CLI's --test.

The port of twopaco_tpu/testing/selftest.py: a sweep of k and round counts
over random mutated genomes, through the sort and the Bloom engines on a
device; the junction marks must equal the naive oracle's exactly, and every
oracle junction k-mer must resolve through Enumerator.get_id.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.passes.pipeline import INVALID_VERTEX, PipelineConfig, build_junctions
from twopaco_tpu_torch.testing import oracle


def run_tests(
    tests: int = 10,
    filter_bits: int = 20,
    length: int = 9000,
    chr_number: int = 6,
    k_values: tuple[int, ...] = (3, 5, 7, 9),
    hash_values: tuple[int, ...] = (1,),
    rounds_values: tuple[int, ...] = (1, 2, 3, 4),
    change_rate: float = 0.05,
    indel_rate: float = 0.1,
    tmpdir: str | None = None,
    seed: int | None = None,
    log=print,
    *,
    device="cuda",
) -> bool:
    """The defaults are the reference's sweep (constructor.cpp:147:
    RunTests(10, 20, 9000, 6, k 3..9 odd, hf {1}, r {1..4}, thr {4})), run
    over both engines on `device` (cuda: the kernels; raises without a
    card; cpu: the plain versions); threads have no counterpart here.
    -> True when every case passed."""
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="twopaco_selftest_", dir=tmpdir) as work:
        out_path = os.path.join(work, "selftest.dbg")
        for t in range(tests):
            base = oracle.generate_sequence(rng, length)
            seqs = [base] + [oracle.mutate_sequence(rng, base, change_rate, indel_rate)
                             for _ in range(chr_number - 1)]
            sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
            for k in k_values:
                junc, want = oracle.find_junctions_naively(seqs, k)
                for rounds in rounds_values:
                    for hf in hash_values:
                        for engine in ("sort", "bloom"):
                            cfg = PipelineConfig(
                                k=k, filter_bits=filter_bits, hash_functions=hf,
                                rounds=rounds, engine=engine, positions_per_row=512,
                                rows_per_batch=8,
                            )
                            enum = build_junctions(None, cfg, out_path, sequences=sequences,
                                                   device=device)
                            case = f"k={k} rounds={rounds} q={hf} engine={engine}"
                            if not _check(out_path, seqs, want, junc, enum, case, log):
                                log(f"Test # {t} FAILED")
                                return False
            log(f"Test # {t} PASSED")
    return True


def _check(out_path, seqs, want, junc, enum, case, log) -> bool:
    """The run's junction positions against the oracle's marks, and every
    oracle junction found by the run's dictionary."""
    c, pos, _ids = junction_io.read_junctions(out_path)
    got = [np.zeros(len(s), bool) for s in seqs]
    for cc, pp in zip(c, pos):
        got[cc][pp] = True
    for i in range(len(seqs)):
        if not np.array_equal(got[i], want[i]):
            bad = np.nonzero(got[i] != want[i])[0]
            log(f"ERROR at chr {i} pos {bad[:5].tolist()} ({case})")
            return False
    for v in junc:
        if enum.get_id(v) == INVALID_VERTEX:
            log(f"GetId failed for {v} ({case})")
            return False
    return True
