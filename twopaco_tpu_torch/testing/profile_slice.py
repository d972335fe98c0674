"""Device time of one warm run of the benchmark slice through an engine of
the port, by torch.profiler.

    python -m twopaco_tpu_torch.testing.profile_slice --engine dist-bloom --shards 4 -f 30
    python -m twopaco_tpu_torch.testing.profile_slice --engine bloom --layout bit -f 34

The slice is chip_smoke.py's: 8 genomes x 8,000,000 bases (seed 2016,
testing/bench_data.py), k=25 (or -k), the CLI's tier (P=2048, B=256).
The engine runs twice on one CUDA device (the first run builds the
kernels and warms the context) and the second is profiled: printed are
its host wall seconds, the device seconds (the union of the device-side
events' intervals: kernels, copies, memsets; the host-side operators that
launched them are not counted again, nor the program's spans, which the
profiler also draws on the device's timeline), the busy share (device
over wall), the kernels that took the most device time, with the card's
name and power limit, each run's spans (trace.py: count, seconds and
self seconds by name, and the counters), and the host-side operators and
runtime calls of the most self CPU time. The dist engines run over a
LocalMesh of --shards shards of the card; the Bloom engines take the filter's --layout (auto: byte while it
fits). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from twopaco_tpu_torch import trace

ENGINES = ("sort", "bloom", "dist", "dist-bloom")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def busy_us(events) -> float:
    """Microseconds in which some device operation ran: the union of the
    device events' intervals (the profiler's device-side ranges of user
    annotations are no device work and are left out)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, t = 0.0, float("-inf")
    for a, b in spans:
        a = max(a, t)
        if b > a:
            busy += b - a
            t = b
    return busy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--engine", choices=ENGINES, default="dist-bloom")
    p.add_argument("--shards", type=int, default=4, help="dist engines: shards of the card")
    p.add_argument("-k", type=int, default=25, help="k-mer length")
    p.add_argument("-f", "--filter-bits", type=int, default=30)
    p.add_argument("-r", "--rounds", type=int, default=1)
    p.add_argument("--layout", choices=("auto", "byte", "bit", "block"), default="auto",
                   help="Bloom engines: the filter's layout")
    p.add_argument("--work", default=os.path.join("chip_smoke_work", "profile"),
                   help="directory for the slice's FASTA and .dbg")
    p.add_argument("--top", type=int, default=10,
                   help="kernels and host operators listed")
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
    cfg = PipelineConfig(k=args.k, rounds=args.rounds, filter_bits=args.filter_bits,
                         layout=args.layout, positions_per_row=2048, rows_per_batch=256,
                         engine=args.engine)

    def run():
        if args.engine.startswith("dist"):
            mesh = LocalMesh([torch.device("cuda", 0)] * args.shards)
            distpipe.build_junctions_dist([fa], cfg, mesh, out, device="cuda",
                                          bloom_gate=args.engine == "dist-bloom")
        else:
            build_junctions([fa], cfg, out, device="cuda")
        torch.cuda.synchronize()

    run()
    first = trace.last_build()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    profiled = trace.last_build()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        print("profile_slice: the profiler recorded no device event", file=sys.stderr)
        return 1
    device_us = busy_us(prof.events())
    card = card_line()
    shards = f", {args.shards} shards" if args.engine.startswith("dist") else ""
    layout = f" --layout {args.layout}" if "bloom" in args.engine else ""
    print(f"profile {args.engine} -k {args.k} -f {args.filter_bits} -r {args.rounds}{layout}{shards} "
          f"[{card}]: "
          f"wall {wall:.3f} s, device {device_us / 1e3:.1f} ms, "
          f"busy {100 * device_us / 1e6 / wall:.1f}%")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[: args.top]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")
    for tag, spans in (("first run", first), ("profiled run", profiled)):
        print(f"spans, {tag} (name: count, seconds, self seconds; counters):")
        for name, row in trace.by_name(spans).items():
            counters = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                for k, v in row["counters"].items())
            print(f"  {name:12s} {row['n']:5d} {row['total']:9.4f} {row['self']:9.4f}  {counters}")
    host = [e for e in prof.key_averages() if e.device_type != DeviceType.CUDA]
    print(f"host operators by self CPU time (profiled run, {len(host)} kinds):")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[: args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
