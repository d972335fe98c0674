"""The benchmark harness: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, on cuda:0 (it exits 1 and prints no result without a card, or
with fewer cards than the cell asks for):
  1. set-up (setup_s, from the start of main): import torch, generate the
     cell's input from --seed (genome.py) and write it as FASTA into a
     fresh directory under TMPDIR, warm what the program's daemon warms
     (twopaco_tpu_torch.cli.serve.warm), and run one build, whose output
     is kept in memory: the checked build;
  2. the window: builds back to back, one at a time, started while the
     window's clock is under --seconds; the window ends with the last
     build's end. A build runs as the daemon runs a request
     (cli/serve.py _serve_one): twopaco_tpu_torch.cli.twopaco.main(argv)
     with its output captured, torch.cuda.synchronize(),
     torch.cuda.empty_cache(). argv is the configuration's -k, the traffic
     mix's flags, the FASTA and -o <a FIFO> that a thread drains and
     compares with the checked build's bytes as they come (sink.py): no
     build writes its .dbg to disk. With --trace 1 the window runs under
     torch.profiler;
  3. after the window: the checked build's .dbg against the plain
     reference's (reference.py, run on the card once the program's memory
     is released), the count of window builds that failed or wrote other
     bytes, the metrics (metrics/<name>.py, the end-to-end ones with
     --trace 0, the per-layer ones with --trace 1), and the result line.

The cell, its configuration, its traffic mix and its metrics are found
by name from BENCHMARK.json: configs[].file, traffic/<traffic>.json,
metrics/<metric>.py. A metric's reader is a module with read(record) ->
float or None (None: nothing to read, the metric is left out). The record
is a plain dict:
  bases, sequences, k, setup_s, window_s (first build start to last build
  end), builds: [{rc, ok, wall_s, stdout}], window_peak_bytes, and with
  --trace 1 trace (devtrace.py's) and records (the round sort's real
  records a build).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "twopaco_tpu")


# ---- the cell, from BENCHMARK.json -------------------------------------


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` with its configuration file, traffic mix and the
    metrics it reports: {name, chips, config, traffic, end_to_end,
    per_layer}."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH.name / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def load_reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py's read function."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + "".join(c if c.isalnum() else "_" for c in metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list[dict], record: dict, root: Path = ROOT) -> dict:
    out = {}
    for m in metrics:
        value = load_reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    twopaco_tpu (whole names: twopaco_tpu_torch is none of them)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _forbidden_loaded(err) -> bool:
    found = forbidden_modules()
    if found:
        print(f"gpubench: modules of jax or the JAX package are loaded: {found}", file=err)
    return bool(found)


# ---- one build --------------------------------------------------------


class Builder:
    """Runs the cell's build as the daemon runs a request. argv: the CLI
    flags; the FASTA and the sink are appended."""

    def __init__(self, argv: list[str], fasta: str, sink_path: str, device: str):
        self.argv = [*argv, fasta, "-o", sink_path]
        self.sink_path = sink_path
        self.device = device

    def run(self, keep: bool = False, expect: bytes | None = None,
            profile_range: bool = False) -> dict:
        import torch

        from twopaco_tpu_torch.cli import twopaco

        from gpubench import devtrace, sink

        drain = sink.Drain(self.sink_path, keep=keep, expect=expect).start()
        out, err = io.StringIO(), io.StringIO()
        rng = (torch.profiler.record_function(devtrace.BUILD_RANGE) if profile_range
               else contextlib.nullcontext())
        cpu0 = _cpu_seconds()
        t0 = time.perf_counter()
        with rng:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                try:
                    rc = int(twopaco.main(list(self.argv)) or 0)
                except SystemExit as e:
                    rc = int(e.code or 0) if not isinstance(e.code, str) else 1
                except Exception:  # noqa: BLE001 - a failed build is counted, not fatal
                    err.write(traceback.format_exc())
                    rc = 1
            if self.device == "cuda" and torch.cuda.is_initialized():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            drain.finish()
        t1 = time.perf_counter()
        return dict(rc=rc, wall_s=t1 - t0, start=t0, end=t1, cpu_s=_cpu_seconds() - cpu0,
                    stdout=out.getvalue(), stderr=err.getvalue(), same=drain.same,
                    size=drain.size, data=drain.data, pipe_bytes=drain.pipe_bytes)


def _cpu_seconds() -> float:
    """The CPU seconds (user + system) of this process so far, all its
    threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


# ---- the run ------------------------------------------------------------


def card_line() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return got.stdout.strip().splitlines()[0] if got.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def log_summary(stdout: str) -> list[str]:
    """The lines of a build's log a reader of the run wants: the mode,
    the rounds, the counts and every time key."""
    keep = ("Engine", "Record slots", "Splitting", "Round ", "True marks", "Distinct",
            "Occurrences", "True junctions", "Merge on", "time\t")
    return [ln for ln in stdout.splitlines() if ln.startswith(keep)]


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        root: Path = ROOT, extra_argv: tuple = (), out=sys.stdout, err=sys.stderr) -> int:
    """One run of the cell; prints the result line to `out` last.
    device="cpu" (tests only) runs the program's plain versions with
    --device cpu and skips the card's checks and readings.
    -> the exit code."""
    t_start = time.perf_counter()
    import torch

    phases = {"import": time.perf_counter() - t_start}

    cell = load_cell(workload, root)
    from twopaco_tpu_torch.cli import serve
    from twopaco_tpu_torch.kernels import build as kbuild

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                  f"device_count = {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 1
    from gpubench import devtrace, genome, peaks, readers, reference, sink

    config, traffic = cell["config"], cell["traffic"]
    k = int(config["k"])
    work = tempfile.mkdtemp(prefix="gpubench-")
    try:
        t0 = time.perf_counter()
        seqs = genome.config_genomes(config, seed)
        fasta = os.path.join(work, "input.fa")
        bases = genome.write_fasta(fasta, seqs)
        phases["input"] = time.perf_counter() - t0
        sink_path = sink.make_fifo(work)
        argv = ["-k", str(k), *traffic["argv"], *extra_argv]
        builder = Builder(argv, fasta, sink_path, device)
        t0 = time.perf_counter()
        serve.warm(device)
        phases["warm"] = time.perf_counter() - t0
        checked = builder.run(keep=True)
        phases["checked build"] = checked["wall_s"]
        setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if checked["rc"] != 0:
            print(checked["stdout"][-4000:] + checked["stderr"][-4000:], file=err)

        # ---- the window
        kbuild.reset_launch_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_setup = time.perf_counter() - t_start
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        builds = []
        t_win = time.perf_counter()
        try:
            while time.perf_counter() - t_win < seconds:
                builds.append(builder.run(expect=checked["data"], profile_range=trace))
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        window_s = builds[-1]["end"] - builds[0]["start"]
        window_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        launches = kbuild.launch_counts()
        if _forbidden_loaded(err):
            return 1

        record = dict(
            bases=bases, sequences=len(seqs), k=k, setup_s=t_setup, window_s=window_s,
            window_peak_bytes=window_peak,
            builds=[dict(rc=b["rc"], ok=b["rc"] == 0 and bool(b["same"]),
                         wall_s=b["wall_s"], stdout=b["stdout"]) for b in builds],
        )
        if prof is not None:
            record["trace"] = devtrace.from_profiler(prof)
            record["records"] = peaks.vertex_records(seqs, k)
            del prof
        del seqs

        # ---- the comparison, once the program's memory is released
        data = checked.pop("data")
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        want, n_junc = reference.reference_dbg(fasta, k, device=device)
        differing = reference.records_differing(data or b"", want)
        t_ref = time.perf_counter() - t_ref
        del want, data
        if device == "cuda":
            torch.cuda.empty_cache()
        bad_builds = sum(not b["ok"] for b in record["builds"])
        compared = {
            "records_differing": {"value": differing, "limit": 0},
            "window_builds_differing": {"value": bad_builds, "limit": 0},
        }
        correct = checked["rc"] == 0 and all(c["value"] <= c["limit"] for c in compared.values())

        metrics = read_metrics(cell["per_layer"] if trace else cell["end_to_end"], record, root)
        dev = dict(platform="gpu" if device == "cuda" else "cpu",
                   kind=torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   count=cell["chips"], memory_peak_bytes=max(setup_peak, window_peak))
        result = dict(correct=bool(correct), attempted=len(builds),
                      failed=sum(b["rc"] != 0 or not b["ok"] for b in record["builds"]),
                      metrics=metrics, device=dev)
        if trace and "trace" in record and record["trace"]["device"]:
            tr = record["trace"]
            dev["busy_s"] = devtrace.busy_seconds(tr)
            dev["window_s"] = tr["span"][1] - tr["span"][0]
            result["breakdown"] = dict(device_ops=devtrace.device_ops(tr),
                                       idle_gaps=devtrace.idle_gaps(tr))
        result["compared"] = compared

        if _forbidden_loaded(err):
            return 1
        print(f"card: {card_line() if device == 'cuda' else 'cpu'}, {cell['chips']} used",
              file=out)
        print(f"cell {workload} seed {seed}: {bases} bases, {record['sequences']} sequences, "
              f"k={k}, argv {' '.join(argv)}", file=out)
        print(f"checked build: rc {checked['rc']}, {checked['size']} bytes "
              f"({checked['size'] // 12} records), {checked['wall_s']:.3f} s, "
              f"pipe {checked['pipe_bytes']} bytes; reference {n_junc} junctions in "
              f"{t_ref:.3f} s", file=out)
        for ln in log_summary(checked["stdout"]):
            print(f"  log: {ln}", file=out)
        print(f"window: {len(builds)} builds in {window_s:.3f} s, walls "
              + " ".join(f"{b['wall_s']:.3f}" for b in builds), file=out)
        done = sum(b["ok"] for b in record["builds"])
        print(f"window rate: {bases * done / window_s / 1e6!r} Mbases/s "
              f"({done} builds with the checked output)", file=out)
        print("window emit: " + " ".join(
            f"{readers.time_keys(b['stdout']).get('emit', float('nan')):.3f}" for b in builds),
            file=out)
        print("window cpu (this process, user + system): "
              + " ".join(f"{b['cpu_s']:.3f}" for b in builds), file=out)
        print(f"launches in the window: {json.dumps(launches, sort_keys=True)}", file=out)
        print(f"setup_s {t_setup:.3f} (" + ", ".join(f"{n} {v:.3f}" for n, v in phases.items())
              + ")", file=out)
        print(json.dumps(result), file=out)
        out.flush()
        for name, c in compared.items():
            print(f"compared {name} {c['value']} limit {c['limit']}", file=err)
        err.flush()
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One run of a benchmark cell (BENCHMARK.json).")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    return run(args.workload, args.seed, args.seconds, bool(args.trace))
