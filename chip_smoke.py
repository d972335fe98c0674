#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from twopaco_tpu_torch/kernels/csrc;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes of the benchmark slice (exact: integer data), and times
   both with CUDA events;
4. runs the port's CLI on two inputs whose .dbg sha256 the JAX package
   gave (tests/golden/torch_port_sha256.json) and checks the bytes;
5. runs the slice: 8 genomes x 8,000,000 bases (seed 2016) through
   `twopaco_tpu_torch.cli.twopaco.main(["-k", "25", "-f", "30", ...])`,
   with every kernel's launch counter reset just before and read just
   after; then the same input through the plain versions on the card,
   whose .dbg must be byte-identical.

Exits non-zero, printing no result, if there is no CUDA device, if the
package is missing, or if any phase fails. The last line of standard
output is the result object.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chip_smoke_work")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_sha256.json")
SLICE = dict(n_seqs=8, length=8_000_000, seed=2016, k=25)
REPLACES = {
    "build_records": ("twopaco_tpu_torch/kernels/csrc/records.cu",
                      "twopaco_tpu/passes/sortpipe.py:143"),
    "sort_records": ("twopaco_tpu_torch/kernels/csrc/sort.cu",
                     "twopaco_tpu/passes/sortpipe.py:365"),
    "judge_compact": ("twopaco_tpu_torch/kernels/csrc/judge.cu",
                      "twopaco_tpu/passes/sortpipe.py:453"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps: int):
    """Mean ms of fn() over reps runs (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    import torch

    from twopaco_tpu_torch.ops import pack

    err = 0
    for a, b in zip(got, want):
        if isinstance(a, int):
            err = max(err, abs(a - b))
            continue
        require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.dtype == torch.uint32:
            a, b = pack.as_i64(a), pack.as_i64(b)
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def compare(name, kernel, plain, reps, results):
    """Run kernel and plain on the same inputs: exact agreement, and
    times taken in turns (plain, kernel, kernel, plain)."""
    import torch

    err = max_abs_err(kernel(), plain())
    torch.cuda.synchronize()
    require(err == 0, f"{name}: kernel disagrees with its plain version (max abs err {err})")
    p1 = timed(plain, reps)
    k1 = timed(kernel, reps)
    k2 = timed(kernel, reps)
    p2 = timed(plain, reps)
    results.setdefault(name, []).append(
        dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    )
    print(f"compare {name}: exact, kernel {(k1 + k2) / 2:.3f} ms, "
          f"plain {(p1 + p2) / 2:.3f} ms")


def phase(name):
    print(f"== {name}", flush=True)


def run_cli(argv) -> str:
    """The port's CLI main(); echoes its output and returns it."""
    from twopaco_tpu_torch.cli.twopaco import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    print(text, end="")
    require(rc == 0, f"twopaco {' '.join(argv)} exited {rc}")
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        from twopaco_tpu_torch.io import fasta, windows
        from twopaco_tpu_torch.kernels import build
        from twopaco_tpu_torch.ops import pack
        from twopaco_tpu_torch.passes import judge, records, sort
        from twopaco_tpu_torch.passes.pipeline import PipelineConfig
        from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted
        from twopaco_tpu_torch.testing import bench_data
    except ImportError as e:
        print(f"chip_smoke: the twopaco_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1

    phase("device")
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    label = f"[{card}]"
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    phase("build kernels")
    build.lib()
    secs = build.LIBRARY.build_seconds
    print("kernel build: " + (f"{secs:.1f} s (nvcc, sm_90a; ptxas report in "
          "twopaco_tpu_torch/kernels/build/build.log)" if secs is not None
          else "reused an existing build") + f" {label}")

    phase("slice data")
    t0 = time.time()
    fa = os.path.join(WORK, "bench_8x8M.fa")
    bench_data.write_bench_fasta(fa, SLICE["n_seqs"], SLICE["length"], SLICE["seed"])
    k = SLICE["k"]
    size = os.path.getsize(fa)
    P, B = (16384, 128) if size >= (64 << 20) else (2048, 256)  # the CLI's tier
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    seqs = [(i, c) for i, _h, c in fasta.read_all_records([fa])]
    batches = list(windows.iter_window_batches(iter(seqs), cfg.window_config()))
    n_slots = len(batches) * B * P
    print(f"slice: {size} bytes, P={P} B={B}, {len(batches)} batches, "
          f"{n_slots} record slots ({time.time() - t0:.1f} s to make)")

    phase("kernels vs plain versions")
    results: dict = {}

    def upload(batch):
        p, m = pack.pack_codes_host(batch.codes)
        return [torch.from_numpy(a).to(dev) for a in (p, m, batch.valid)]

    # record build: one batch at k=25 (full gate and a narrow hash gate)
    # and one at k=101
    args = upload(batches[0])
    for low, high in ((0, 0xFFFFFFFF), (1 << 30, 3 << 30)):
        compare(
            "build_records",
            lambda: records.build_sort_records(*args, 0, k=k, P=P, low=low, high=high),
            lambda: records.build_sort_records_plain(*args, 0, k=k, P=P, low=low, high=high),
            10, results,
        )
    cfg101 = PipelineConfig(k=101, positions_per_row=P, rows_per_batch=B)
    b101 = next(windows.iter_window_batches(iter(seqs), cfg101.window_config()))
    args101 = upload(b101)
    compare(
        "build_records_k101",
        lambda: records.build_sort_records(*args101, 0, k=101, P=P),
        lambda: records.build_sort_records_plain(*args101, 0, k=101, P=P),
        5, results,
    )
    # the slice's whole round buffer, built as the main path builds it
    w = cfg.w
    buf = (
        torch.empty((n_slots, w), dtype=torch.uint32, device=dev),
        torch.empty(n_slots, dtype=torch.uint32, device=dev),
        torch.empty(n_slots, dtype=torch.int64, device=dev),
    )
    for b in batches:
        off = b.row0 * P
        records.build_sort_records(
            *upload(b), off, k=k, P=P,
            out=tuple(t[off : off + B * P] for t in buf),
        )
    torch.cuda.synchronize()
    compare("sort_records", lambda: sort.sort_records(*buf),
            lambda: sort.sort_records_plain(*buf), 3, results)
    srt = sort.sort_records(*buf)
    del buf
    for ab in (judge.NO_ABUNDANCE, 4):
        compare(
            "judge_compact",
            lambda: judge.judge_compact(*srt, ab),
            lambda: judge.judge_compact_plain(*srt, ab),
            3, results,
        )
    del srt
    torch.cuda.synchronize()

    phase("golden sha256 (JAX package outputs)")
    with open(GOLDEN) as f:
        golden = json.load(f)
    for name, spec in golden.items():
        src = spec["input"]
        if src.startswith("bench:"):
            n, length, seed = (int(x) for x in src[6:].split(":"))
            src = bench_data.write_bench_fasta(
                os.path.join(WORK, f"{name}.fa"), n, length, seed)
        else:
            src = os.path.join(ROOT, src)
        out = os.path.join(WORK, f"{name}.dbg")
        run_cli(["-k", str(spec["k"]), "-f", "20", src, "-o", out])
        got = sha256(out)
        require(got == spec["sha256"], f"{name}: .dbg sha256 {got} != {spec['sha256']}")
        print(f"golden {name}: sha256 matches the JAX package")
    torch.cuda.synchronize()

    phase("slice: port CLI on the 8 x 8 Mbase input")
    out = os.path.join(WORK, "slice.dbg")
    build.reset_launch_counts()
    t0 = time.time()
    text = run_cli(["-k", str(k), "-f", "30", fa, "-o", out])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = build.launch_counts()
    print(f"launches in the slice run: {launches}")
    for name in REPLACES:
        require(launches.get(name, 0) > 0, f"{name}: no launch in the slice run")
    times = {
        line.split("\t")[1]: float(line.split("\t")[2])
        for line in text.splitlines() if line.startswith("time\t")
    }
    bases = SLICE["n_seqs"] * SLICE["length"]
    print(f"slice phases (s) {label}: " + ", ".join(
        f"{n}={times[n]:.3f}" for n in ("read", "windows", "upload", "build",
                                        "sort", "judge", "fetch", "merge",
                                        "emit", "total")))
    print(f"slice: {bases} bases in {wall:.3f} s wall = "
          f"{bases / wall / 1e6:.2f} Mbases/s {label}")
    slice_sha = sha256(out)
    size_dbg = os.path.getsize(out)
    require(size_dbg > 0 and size_dbg % 12 == 0, f"slice .dbg has {size_dbg} bytes")

    phase("slice: plain versions on the card")
    out_ref = os.path.join(WORK, "slice_plain.dbg")
    t0 = time.time()
    build_junctions_sorted([fa], cfg, out_ref, device=dev, reference=True)
    torch.cuda.synchronize()
    print(f"plain-version slice run: {time.time() - t0:.3f} s wall {label}")
    require(sha256(out_ref) == slice_sha, "slice .dbg differs between kernels and plain versions")
    print(f"slice .dbg: {size_dbg} bytes, sha256 {slice_sha}, identical to the plain run")
    shutil.rmtree(WORK, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        rs = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=rs[0]["ms"], plain_ms=rs[0]["plain_ms"],
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
