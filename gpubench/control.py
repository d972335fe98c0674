"""The control of the comparison that decides `correct`, and the
readings the comparison's limits were set from.

The configuration states an exact junction list. The control is the plain
reference put in the program's place with that guarantee broken the way a
faster build would be tempted to break it: vertices are joined by a 32-bit
fingerprint of their canonical k-mer instead of the whole k-mer (a Bloom
filter's candidates left unverified), so k-mers whose fingerprints collide
count as one vertex and their extensions mix. The ids stay ranks of the
true k-mers. It has to come out as not correct.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For each of --seeds, in one process on the card: the input generated as
a run generates it, one build of the program as the harness's checked
build, and the number compared (records_differing against the reference);
for each of --control-seeds the control's records_differing. One JSON line
a reading, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from gpubench import reference  # noqa: E402


def fingerprint_keys(canon):
    """A 32-bit fingerprint of each canonical k-mer code: its two halves
    folded by xor."""
    return (canon ^ (canon >> 32)) & 0xFFFFFFFF


def control_dbg(fasta_path: str, k: int, device="cpu"):
    """The control's .dbg bytes and junction count."""
    return reference.reference_dbg(fasta_path, k, device, join=fingerprint_keys)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    from twopaco_tpu_torch.cli import serve

    from gpubench import genome, harness, sink

    cell = harness.load_cell(args.workload)
    config, k = cell["config"], int(cell["config"]["k"])
    serve.warm("cuda")
    readings = {"program": [], "control": []}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        work = tempfile.mkdtemp(prefix="gpubench-control-")
        try:
            fasta = os.path.join(work, "input.fa")
            genome.write_fasta(fasta, genome.config_genomes(config, seed))
            got = {}
            if seed in args.seeds:
                b = harness.Builder(["-k", str(k), *cell["traffic"]["argv"]], fasta,
                                    sink.make_fifo(work), "cuda").run(keep=True)
                got["program"] = (b["data"] or b"", b["rc"], b["wall_s"])
            t0 = time.perf_counter()
            want, n_junc = reference.reference_dbg(fasta, k, "cuda")
            t_ref = time.perf_counter() - t0
            if seed in args.control_seeds:
                t0 = time.perf_counter()
                ctrl, _n = control_dbg(fasta, k, "cuda")
                got["control"] = (ctrl, 0, time.perf_counter() - t0)
            for side, (data, rc, secs) in got.items():
                diff = reference.records_differing(data, want)
                readings[side].append(diff if rc == 0 else None)
                print(json.dumps(dict(side=side, seed=seed, records_differing=diff, rc=rc,
                                      seconds=secs, reference_s=t_ref, junctions=n_junc,
                                      records=len(want) // 12)), flush=True)
            del want, got
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(work, ignore_errors=True)
    summary = {side: dict(n=len(v), max=max((x for x in v if x is not None), default=None),
                          min=min((x for x in v if x is not None), default=None),
                          failed=sum(x is None for x in v))
               for side, v in readings.items()}
    print(json.dumps(dict(workload=args.workload, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
