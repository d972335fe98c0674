"""graphdump CLI of the port: convert the binary junction list to text
formats (reference graphdump.cpp:608-709).

    python -m twopaco_tpu_torch.cli.graphdump -f gfa1 -k 25 -s genomes.fa out.dbg

The JAX package's flags: -f/--format (seq, group, dot, gfa1, gfa2,
fasta), -s/--seqfile (once a FASTA file, required by gfa1, gfa2 and
fasta), -k/--kvalue, --prefix. Host work only: no device.
"""

from __future__ import annotations

import argparse
import sys

from twopaco_tpu_torch.formats import graphdump as gd

FORMATS = ["seq", "group", "dot", "gfa1", "gfa2", "fasta"]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphdump",
        description=(
            "This utility converts the binary output of twopaco to "
            "another format"
        ),
    )
    p.add_argument(
        "--prefix", action="store_true",
        help="Add a prefix to segments in GFA (identical FASTA headers)",
    )
    p.add_argument("infile", help="input file name")
    p.add_argument(
        "-f", "--format", choices=FORMATS, default="seq",
        help="Output format",
    )
    p.add_argument(
        "-s", "--seqfile", action="append", default=[],
        help="sequences file name (required for gfa/fasta)",
    )
    p.add_argument("-k", "--kvalue", type=int, required=True, help="Value of k")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    out = sys.stdout
    try:
        if args.format == "seq":
            gd.generate_seq(args.infile, out)
        elif args.format == "group":
            gd.generate_group(args.infile, out)
        elif args.format == "dot":
            gd.generate_dot(args.infile, out)
        else:
            if not args.seqfile:
                print(
                    "error: Required argument missing: seqfilename",
                    file=sys.stderr,
                )
                return 1
            if args.format == "gfa1":
                gd.generate_gfa(
                    args.infile, args.seqfile, args.kvalue, out,
                    version=1, prefix=args.prefix,
                )
            elif args.format == "gfa2":
                gd.generate_gfa(
                    args.infile, args.seqfile, args.kvalue, out,
                    version=2, prefix=args.prefix,
                )
            elif args.format == "fasta":
                gd.generate_fasta(args.infile, args.seqfile, args.kvalue, out)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream consumer (head, less) closed the pipe — normal
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
