"""Device time of the device merge (passes/merge.py merge_packed) on the
benchmark slice's keyed entries.

    python -m twopaco_tpu_torch.testing.profile_merge [--runs sort_r4 dist_r1 dist_r4]

The slice is chip_smoke.py's (8 genomes x 8,000,000 bases, seed 2016,
testing/bench_data.py), k=25, P=2048, B=256. Each run (sort -r 4
resident; dist over 4 shards of the card at -r 1 and -r 4) goes through
the port once, keeping the keyed entries it hands the merge; they are
uploaded, and merge_packed (the kernels) and merge_packed_plain (the
plain versions on the card) are timed: event ms a call, the mean of
--reps calls, each on a fresh copy of the keys made outside the time (an
in-place merge may rewrite its keys), and the device ms of the kernels of
one call profiled by torch.profiler, kernel by kernel. Prints the card's
name and power limit, and one JSON line a run. Only merge_packed's
signature is used, so an older tree's merge can be timed the same way
(copy this file into it). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUNS = ("sort_r4", "dist_r1", "dist_r4")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def entries_of(run: str, fa: str, out: str):
    """The keyed entries a run of the slice hands sortpipe.merge_fetched."""
    import torch

    from twopaco_tpu_torch.parallel import distpipe
    from twopaco_tpu_torch.parallel.mesh import LocalMesh
    from twopaco_tpu_torch.passes import sortpipe
    from twopaco_tpu_torch.passes.pipeline import PipelineConfig, build_junctions

    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, *a, **kw):
        got["fetched"] = list(fetched)
        return orig(fetched, *a, **kw)

    cfg = PipelineConfig(k=25, rounds=int(run[-1]), filter_bits=30, positions_per_row=2048,
                         rows_per_batch=256)
    sortpipe.merge_fetched = capture
    try:
        if run.startswith("dist"):
            distpipe.build_junctions_dist([fa], cfg, LocalMesh([torch.device("cuda", 0)] * 4),
                                          out, device="cuda")
        else:
            build_junctions([fa], cfg, out, device="cuda")
    finally:
        sortpipe.merge_fetched = orig
    torch.cuda.synchronize()
    return got["fetched"], cfg


def time_merge(fn, tab, keys, ent, k: int, id_bits: int, reps: int) -> float:
    """Mean event ms of fn over reps calls, each on a fresh copy of keys."""
    import torch

    kk = keys.clone()
    fn(tab, kk, ent, key_bits=2 * k, id_bits=id_bits)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        kk.copy_(keys)
        torch.cuda.synchronize()
        start.record()
        fn(tab, kk, ent, key_bits=2 * k, id_bits=id_bits)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_kernels(fn, tab, keys, ent, k: int, id_bits: int) -> dict[str, float]:
    """Device ms of each kernel of one call (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kk = keys.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(tab, kk, ent, key_bits=2 * k, id_bits=id_bits)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--work", default=os.path.join("chip_smoke_work", "profile"),
                   help="directory for the slice's FASTA and .dbg")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_merge: no CUDA device", file=sys.stderr)
        return 1
    from twopaco_tpu_torch.passes import merge
    from twopaco_tpu_torch.testing import bench_data

    os.makedirs(args.work, exist_ok=True)
    fa = os.path.join(args.work, "bench_8x8M.fa")
    if not os.path.exists(fa):
        bench_data.write_bench_fasta(fa, 8, 8_000_000, 2016)
    card = card_line()
    dev = torch.device("cuda", 0)
    for run in args.runs:
        fetched, cfg = entries_of(run, fa, os.path.join(args.work, f"merge_{run}.dbg"))
        id_bits = fetched[0][1].id_bits
        tables = [t for t, _k, _n in fetched]
        keys = [kk.keys for _t, kk, _n in fetched]
        ofs = np.cumsum([[0] + [len(x) for x in keys], [0] + [len(t) for t in tables]], axis=1)
        tab = torch.from_numpy(np.concatenate(tables)).to(dev)
        kd = torch.cat(keys).to(dev)
        ent = torch.from_numpy(ofs).to(dev)
        res = dict(run=run, entries=len(fetched), rows=tab.shape[0], keys=kd.numel(), card=card)
        res["kernel_ms"] = time_merge(merge.merge_packed, tab, kd, ent, cfg.k, id_bits,
                                      args.reps)
        res["device_ms"] = device_kernels(merge.merge_packed, tab, kd, ent, cfg.k, id_bits)
        res["plain_ms"] = time_merge(merge.merge_packed_plain, tab, kd, ent, cfg.k, id_bits,
                                     max(1, args.reps // 4))
        res["kernel_ms_again"] = time_merge(merge.merge_packed, tab, kd, ent, cfg.k, id_bits,
                                            args.reps)
        dev_total = sum(res["device_ms"].values())
        print(f"merge {run} [{card}]: {res['entries']} entries, {res['rows']} rows, "
              f"{res['keys']} keys; merge_packed {res['kernel_ms']:.4f}, "
              f"{res['kernel_ms_again']:.4f} ms (events), device {dev_total:.4f} ms; plain "
              f"{res['plain_ms']:.3f} ms")
        for name, ms in sorted(res["device_ms"].items(), key=lambda x: -x[1]):
            print(f"  {ms:9.4f} ms  {name}")
        print("PROFILE_MERGE " + json.dumps(res), flush=True)
        del tab, kd, ent, fetched
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
