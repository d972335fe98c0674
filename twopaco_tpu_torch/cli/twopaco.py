"""twopaco CLI of the port: junction enumeration on a CUDA device
(reference constructor.cpp:53-176).

    python -m twopaco_tpu_torch.cli.twopaco -k 25 -f 30 genomes.fa -o out.dbg

Flag-compatible with the reference binary: -k/--kvalue, -f/--filtersize
XOR --filtermemory, -q/--hashfnumber, -r/--rounds, -t/--threads,
-a/--abundance, --tmpdir, --test, -o/--outfile, positional FASTA files;
the JAX package's --tpu-engine, --tpu-layout, --tpu-positions, --tpu-rows
and --tpu-checkpoint; --tpu-profile DIR writes a torch.profiler trace of
the run (the program's spans, the host's operators and, on a card, the
device's work, on one clock) to DIR/twopaco.trace.json, a Chrome trace.

--tpu-engine sort (the default) is the sort-join engine: it has no Bloom
filter, so -f, --filtermemory and -q are checked and otherwise unused;
-r N splits the run into at least N rounds by vertex hash (more when the
input does not fit the device in N) and the TWOPACO_* variables of
passes/sortpipe.py pick the multi-round mode. --tpu-engine bloom is the
reference's Bloom-filter algorithm (passes/bloompipe.py): a 2^f-slot
filter (--filtermemory GB: f = log2(GB * 8e9), as the reference) with q
hash functions in the --tpu-layout (auto: byte up to f = 30, else bit;
block: 256-bit blocks keyed by vertex), -r N rounds exactly, candidate
masks spilled to --tmpdir above TWOPACO_MASK_SPILL_BYTES. --tpu-engine
dist is the distributed sort-join engine (parallel/distpipe.py) over one
shard per visible CUDA device (one CPU shard with --device cpu); -r N as
the sort engine's. --tpu-engine dist-bloom is the dist engine gated by a
Bloom filter of 2^f slots sharded over those shards (parallel/sharded.py;
the layout resolved for a shard's ceil(2^f / D) slots, byte or bit: the
block layout is refused). All four write the same bytes. --tpu-checkpoint DIR checkpoints each round, and a rerun
resumes. --device picks the device: cuda (the default; raises when there
is no card) or cpu (the plain PyTorch versions). -t is accepted and
unused. --test runs the reference's randomized self test
(testing/selftest.py: the sort and Bloom engines against the naive
oracle) on --device and exits 0 when it passes, else 1.

A run is one span tree (trace.py) under the root span `twopaco`. After
the counts it prints a `time\t<phase>\t<seconds>` line a phase of the
engine (the seconds of its spans, summed; 0.000 where it did not run)
and, once the root has closed, `span\t<name>\t<count>\t<seconds>\t<self
seconds>` a span name and `counter\t<span name>\t<key>\t<value>` a
counter of the tree.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys

from twopaco_tpu_torch import trace


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
        help="Number of computation rounds (at least; more when the "
        "input does not fit the device)",
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
    p.add_argument("--test", action="store_true", help="Run tests")
    p.add_argument(
        "-o", "--outfile", default="de_bruijn.bin",
        help="Output file name prefix",
    )
    p.add_argument(
        "--tpu-checkpoint", default=None, metavar="DIR",
        help="Round-boundary checkpoint directory (resume on rerun)",
    )
    p.add_argument(
        "--tpu-profile", default=None, metavar="DIR",
        help="Write a torch.profiler trace of the run to DIR (a Chrome trace: "
        "the spans, host operators and device work on one clock)",
    )
    p.add_argument(
        "--tpu-engine", choices=["sort", "bloom", "dist", "dist-bloom"],
        default="sort",
        help="Engine: sort-join (default), Bloom two-pass, the distributed "
        "sort-join over the visible devices, or the same gated by a Bloom "
        "filter sharded over them (dist-bloom)",
    )
    p.add_argument(
        "--tpu-layout", choices=["auto", "byte", "bit", "block"],
        default="auto",
        help="Bloom filter layout (bloom and dist-bloom engines; block = "
        "vertex-blocked, bloom only: one 32-byte block holds all 8 edge "
        "extensions of a vertex)",
    )
    p.add_argument(
        "--tpu-positions", type=int, default=None,
        help="Window positions per row (default: by input size)",
    )
    p.add_argument(
        "--tpu-rows", type=int, default=None,
        help="Rows per batch (default: by input size)",
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

    if args.test:
        from twopaco_tpu_torch.passes.sortpipe import resolve_device
        from twopaco_tpu_torch.testing.selftest import run_tests

        # the reference's sweep (constructor.cpp:147: run_tests' defaults)
        ok = run_tests(tmpdir=args.tmpdir if args.tmpdir != "." else None,
                       device=resolve_device(args.device))
        return 0 if ok else 1

    with _profiled(args.tpu_profile, args.device):
        with trace.span("twopaco"):
            rc = _run(args)
    if rc == 0:
        _print_spans(trace.last_build())
    return rc


def _run(args) -> int:
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

    if args.filtersize is not None:
        filter_bits = args.filtersize
    else:
        # the reference's conversion (constructor.cpp:158): log2 of decimal
        # GB * 8e9 bits, truncated
        filter_bits = int(math.log2(args.filtermemory * 8e9))

    from twopaco_tpu_torch.passes.pipeline import PipelineConfig, build_junctions
    from twopaco_tpu_torch.passes.sortpipe import resolve_device

    device = resolve_device(args.device)  # raises without a card
    # the JAX package's batch tiers (cli/twopaco.py:148-156): the output
    # does not depend on them, so they stay for like-for-like runs
    try:
        total_sz = sum(os.path.getsize(f) for f in args.filenames)
    except OSError:
        total_sz = 0
    tier = (16384, 128) if total_sz >= (64 << 20) else (2048, 256)
    positions = args.tpu_positions if args.tpu_positions is not None else tier[0]
    rows = args.tpu_rows if args.tpu_rows is not None else tier[1]
    try:
        cfg = PipelineConfig(
            k=args.kvalue,
            rounds=args.rounds,
            abundance=args.abundance,
            positions_per_row=positions,
            rows_per_batch=rows,
            filter_bits=filter_bits,
            hash_functions=args.hashfnumber,
            layout=args.tpu_layout,
            engine=args.tpu_engine,
        )
        enum = build_junctions(
            args.filenames, cfg, out_path=args.outfile, log=print,
            checkpoint_dir=args.tpu_checkpoint,
            tmpdir=args.tmpdir if args.tmpdir != "." else None, device=device,
        )
    except (OSError, RuntimeError, ValueError) as e:
        # FASTA errors, round and route overflows, inputs that fit no mode,
        # filters past their layout, rows not a multiple of the devices
        print(f"Error: {e}", file=sys.stderr)
        return 1
    with trace.span("report"):
        print(f"Distinct junctions = {enum.vertices_count}")
        # one line per phase, summed over rounds: the same keys in every mode
        for name, val in enum.stats.timings.items():
            print(f"time\t{name}\t{val:.3f}")
        print()
    return 0


@contextlib.contextmanager
def _profiled(directory: str | None, device: str):
    """Run the block under torch.profiler (the CPU, and CUDA for a cuda
    run) and write its Chrome trace to directory/twopaco.trace.json; with
    no directory, run it as it is."""
    if directory is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda" and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(directory, "twopaco.trace.json")
    prof.export_chrome_trace(path)
    print(f"Profile trace = {path}")


def _print_spans(spans) -> None:
    """The span tree's `span` and `counter` lines (module docstring)."""
    for name, row in trace.by_name(spans).items():
        print(f"span\t{name}\t{row['n']}\t{row['total']:.6f}\t{row['self']:.6f}")
        for key, val in row["counters"].items():
            print(f"counter\t{name}\t{key}\t{val:.6f}" if isinstance(val, float)
                  else f"counter\t{name}\t{key}\t{val}")


if __name__ == "__main__":
    sys.exit(main())
