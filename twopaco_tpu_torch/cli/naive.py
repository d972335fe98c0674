"""naive constructor of the port: the exact junction list without the
Bloom or sort pipeline (reference naiveconstructor.cpp:61-220).

    python -m twopaco_tpu_torch.cli.naive -k 25 genomes.fa -o out.dbg

The port of twopaco_tpu/cli/naive.py. Unlike the reference, which writes
unsigned sequential ids, it uses the pipeline's id scheme (signed ranks in
the sorted canonical k-mer table, stub ids in input order), so its output
is byte-identical to `twopaco`'s on any input: an end-to-end oracle for
small data. Host work only: no device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.io import fasta as fasta_io
from twopaco_tpu_torch.io import junctions as junction_io
from twopaco_tpu_torch.passes.pipeline import STUB_ID_OFFSET
from twopaco_tpu_torch.testing import oracle


def naive_junction_file(seqs: list[str], k: int, out_path: str) -> int:
    """Write the junction list of the sequences (text, ambiguity letters
    kept) to out_path. -> the number of distinct junctions."""
    junc, marks = oracle.find_junctions_naively(seqs, k)
    canon = sorted({min(s, dna.revcomp_str(s)) for s in junc})
    if canon:
        keys = dna.words_to_bytes_keys(np.stack([dna.pack_kmer_str(s) for s in canon]))
    else:
        keys = np.zeros(0, dtype="S4")

    def lookup(kmer: str) -> int:
        key = dna.words_to_bytes_keys(dna.pack_kmer_str(kmer)[None, :])[0]
        i = int(np.searchsorted(keys, key))
        return i + 1 if i < len(keys) and keys[i] == key else 0

    stub_id = len(canon) + STUB_ID_OFFSET
    rows = []  # (chr, pos, id) in stream order
    for sid, s in enumerate(seqs):
        if len(s) < k:
            continue
        for pos in np.nonzero(marks[sid])[0]:
            kmer = s[pos : pos + k]
            jid = None
            if all(c in "ACGT" for c in kmer):
                jid = lookup(kmer) or -lookup(dna.revcomp_str(kmer)) or None
            if jid is None:
                if pos == 0 or pos == len(s) - k:
                    jid = stub_id
                    stub_id += 1
                else:  # pragma: no cover - a mark implies a junction
                    continue
            rows.append((sid, int(pos), jid))
    with junction_io.ChunkWriter(out_path) as w:
        if rows:
            chrs, pos, ids = (np.asarray(col, np.int64) for col in zip(*rows))
            w.write(chrs, pos, ids)
    return len(canon)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="naiveconstructor",
        description="Exact (oracle) junction list constructor",
    )
    p.add_argument("-k", "--kvalue", type=int, default=25)
    p.add_argument("-o", "--outfile", default="de_bruijn.bin")
    p.add_argument("filenames", nargs="+")
    args = p.parse_args(argv)
    if args.kvalue % 2 != 1:
        print("Error: value of K must be odd", file=sys.stderr)
        return 1
    seqs = list(fasta_io.read_sequences_text(args.filenames))
    n = naive_junction_file(seqs, args.kvalue, args.outfile)
    print(f"Distinct junctions = {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
