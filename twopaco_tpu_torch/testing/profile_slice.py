"""Device time of one warm run of the benchmark slice through an engine of
the port, by torch.profiler.

    python -m twopaco_tpu_torch.testing.profile_slice --engine dist-bloom --shards 4 -f 30

The slice is chip_smoke.py's: 8 genomes x 8,000,000 bases (seed 2016,
testing/bench_data.py), k=25, the CLI's tier (P=2048, B=256). The engine
runs twice on one CUDA device (the first run builds the kernels and warms
the context) and the second is profiled: printed are its host wall
seconds, the device seconds (the sum of the device-side events' time:
kernels, copies, memsets; the host-side operators that launched them are
not counted again), the busy share (device over wall), and the
kernels that took the most device time, with the card's name and power
limit. The dist engines run over a LocalMesh of --shards shards of the
card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ENGINES = ("sort", "bloom", "dist", "dist-bloom")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--engine", choices=ENGINES, default="dist-bloom")
    p.add_argument("--shards", type=int, default=4, help="dist engines: shards of the card")
    p.add_argument("-f", "--filter-bits", type=int, default=30)
    p.add_argument("-r", "--rounds", type=int, default=1)
    p.add_argument("--work", default=os.path.join("chip_smoke_work", "profile"),
                   help="directory for the slice's FASTA and .dbg")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from twopaco_tpu_torch.parallel import distpipe
    from twopaco_tpu_torch.parallel.mesh import LocalMesh
    from twopaco_tpu_torch.passes.pipeline import PipelineConfig, build_junctions
    from twopaco_tpu_torch.testing import bench_data

    os.makedirs(args.work, exist_ok=True)
    fa = os.path.join(args.work, "bench_8x8M.fa")
    if not os.path.exists(fa):
        bench_data.write_bench_fasta(fa, 8, 8_000_000, 2016)
    out = os.path.join(args.work, "profile.dbg")
    cfg = PipelineConfig(k=25, rounds=args.rounds, filter_bits=args.filter_bits,
                         positions_per_row=2048, rows_per_batch=256, engine=args.engine)

    def run():
        if args.engine.startswith("dist"):
            mesh = LocalMesh([torch.device("cuda", 0)] * args.shards)
            distpipe.build_junctions_dist([fa], cfg, mesh, out, device="cuda",
                                          bloom_gate=args.engine == "dist-bloom")
        else:
            build_junctions([fa], cfg, out, device="cuda")
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        wall = time.time() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile_slice: the profiler recorded no device event", file=sys.stderr)
        return 1
    device_us = sum(e.self_device_time_total for e in events)
    card = card_line()
    shards = f", {args.shards} shards" if args.engine.startswith("dist") else ""
    print(f"profile {args.engine} -f {args.filter_bits} -r {args.rounds}{shards} [{card}]: "
          f"wall {wall:.3f} s, device {device_us / 1e3:.1f} ms, "
          f"busy {100 * device_us / 1e6 / wall:.1f}%")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[: args.top]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
