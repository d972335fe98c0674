"""Time the sort engine's host-merge fallback on a card's host: the keyed
entries of a `-r 4` build of a benchmark configuration, merged again by
sortpipe.merge_rounds_packed with 1 byte of free device memory (so the
host merge runs, as when the free memory is short), with the bytes of the
build's own output checked.

    python3 scripts/time_host_merge.py --tree . --fasta work/ecoli62.fa --out res.json

--tree: the checkout whose twopaco_tpu_torch is timed (another checkout's,
to compare two versions in one call, one process each); the input comes
from this checkout's gpubench (--config, --seed), written to --fasta once
and read from there after. Prints and appends one JSON line a run: the
card, the build's and each merge's seconds, the merge's `merge`, `emit`,
`emit_stub` and `emit_write` spans and the `emit_write` counters."""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def card() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", required=True)
    p.add_argument("--fasta", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="ecoli62",
                   help="a configuration of gpubench/configs, or a .json file's path")
    p.add_argument("--seed", type=int, default=2500000001)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--label", default=None)
    p.add_argument("--device", default="cuda", help="cuda; cpu rehearses at a tiny size")
    args = p.parse_args(argv)
    sys.path[:0] = [os.path.abspath(args.tree), ROOT]

    import torch

    from gpubench import genome
    from twopaco_tpu_torch import trace
    from twopaco_tpu_torch.passes import sortpipe
    from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats

    path = args.config if args.config.endswith(".json") else os.path.join(
        ROOT, "gpubench", "configs", f"{args.config}.json")
    with open(path) as f:
        config = json.load(f)
    if not os.path.exists(args.fasta):
        os.makedirs(os.path.dirname(os.path.abspath(args.fasta)), exist_ok=True)
        genome.write_fasta(args.fasta, genome.config_genomes(config, args.seed))
    work = os.path.dirname(os.path.abspath(args.out))
    cfg = PipelineConfig(k=int(config["k"]), rounds=args.rounds, filter_bits=30)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, batches, *a, **kw):
        got.update(fetched=list(fetched), batches=batches)
        return orig(fetched, batches, *a, **kw)

    built = os.path.join(work, "built.dbg")
    sortpipe.merge_fetched = capture
    try:
        for _ in range(2):  # the first build compiles and warms
            sync()
            t0 = time.perf_counter()
            sortpipe.build_junctions_sorted([args.fasta], cfg, built, device=dev)
            sync()
            build_s = time.perf_counter() - t0
    finally:
        sortpipe.merge_fetched = orig
    want = sha256(built)
    os.remove(built)
    res = dict(label=args.label or args.tree, card=card(), config=args.config, seed=args.seed,
               rounds=len(got["fetched"]), keys=sum(len(e[1]) for e in got["fetched"]),
               build_s=build_s, runs=[])
    out = os.path.join(work, "host_merge.dbg")
    for _ in range(args.reps):
        lines = []
        t0 = time.perf_counter()
        with trace.span("twopaco") as root:
            sortpipe.merge_rounds_packed(got["fetched"], got["batches"], cfg, out, RunStats(),
                                         lines.append, dev=dev, free=1)
        wall = time.perf_counter() - t0
        tot = trace.totals(root)
        (write,) = [s for s in trace.descendants(root) if s.name == "emit_write"]
        res["runs"].append(dict(
            wall_s=wall, **{f"{n}_s": tot.get(n, 0.0) for n in
                            ("merge", "emit", "emit_stub", "emit_write")},
            counters=dict(write.counters),
            host_merge=any(s.startswith("Merge on the host") for s in lines),
            same_bytes=sha256(out) == want))
        os.remove(out)
    line = json.dumps(res)
    print("TIME_HOST_MERGE " + line, flush=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
