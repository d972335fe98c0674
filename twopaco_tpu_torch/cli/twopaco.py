"""twopaco CLI of the port: junction enumeration on a CUDA device
(reference constructor.cpp:53-176).

    python -m twopaco_tpu_torch.cli.twopaco -k 25 -f 30 genomes.fa -o out.dbg

Flag-compatible with the reference binary: -k/--kvalue, -f/--filtersize
XOR --filtermemory, -q/--hashfnumber, -r/--rounds, -t/--threads,
-a/--abundance, --tmpdir, -o/--outfile, positional FASTA files. The
sort-join engine has no Bloom filter, so -f, --filtermemory and -q are
checked and otherwise unused, as are -t and --tmpdir. --device picks
the device: cuda (the default; raises when there is no card) or cpu
(the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="twopaco",
        description=(
            "Program for construction of the condensed de Bruijn graph "
            "from complete genomes (PyTorch + CUDA)"
        ),
    )
    p.add_argument("-k", "--kvalue", type=int, default=25, help="Value of k (odd)")
    p.add_argument(
        "-f", "--filtersize", type=int, default=None,
        help="Size of the filter (log2 of slot count)",
    )
    p.add_argument(
        "--filtermemory", type=float, default=None,
        help="Memory in GBs allocated for the filter",
    )
    p.add_argument(
        "-q", "--hashfnumber", type=int, default=5,
        help="Number of hash functions",
    )
    p.add_argument(
        "-r", "--rounds", type=int, default=1,
        help="Number of computation rounds (only 1 is ported)",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=1,
        help="Number of worker threads (accepted for compatibility)",
    )
    p.add_argument(
        "-a", "--abundance", type=int, default=(1 << 64) - 1,
        help="Vertex abundance threshold",
    )
    p.add_argument("--tmpdir", default=".", help="Temporary directory name")
    p.add_argument(
        "-o", "--outfile", default="de_bruijn.bin",
        help="Output file name prefix",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda: the hand-written kernels (default); cpu: the plain "
        "PyTorch versions",
    )
    p.add_argument("filenames", nargs="*", help="FASTA file(s)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)

    if args.kvalue % 2 != 1:
        print("Error: value of K must be odd", file=sys.stderr)
        return 1
    if not args.filenames:
        print("Error: no input files", file=sys.stderr)
        return 1
    if (args.filtersize is None) == (args.filtermemory is None):
        print(
            "Error: exactly one of -f/--filtersize or --filtermemory "
            "is required",
            file=sys.stderr,
        )
        return 1

    from twopaco_tpu_torch.passes.pipeline import PipelineConfig
    from twopaco_tpu_torch.passes.sortpipe import (
        build_junctions_sorted,
        resolve_device,
    )

    device = resolve_device(args.device)  # raises without a card
    # the JAX package's batch tiers (cli/twopaco.py:148-156): the output
    # does not depend on them, so they stay for like-for-like runs
    try:
        total_sz = sum(os.path.getsize(f) for f in args.filenames)
    except OSError:
        total_sz = 0
    positions, rows = (16384, 128) if total_sz >= (64 << 20) else (2048, 256)
    try:
        cfg = PipelineConfig(
            k=args.kvalue,
            rounds=args.rounds,
            abundance=args.abundance,
            positions_per_row=positions,
            rows_per_batch=rows,
        )
        enum = build_junctions_sorted(
            args.filenames, cfg, out_path=args.outfile, log=print,
            device=device,
        )
    except (OSError, RuntimeError, ValueError) as e:
        # includes MultiRoundUnsupported (-r > 1, or an input too large
        # for one round) and FASTA errors
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Distinct junctions = {enum.vertices_count}")
    for name, val in enum.stats.timings.items():
        print(f"time\t{name}\t{val:.3f}")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
