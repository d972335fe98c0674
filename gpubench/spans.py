"""The program's span tree as a build reports it, and the idle gaps of a
traced window named by it.

A build of the port prints, once its root span `twopaco` has closed,
`span\\t<name>\\t<count>\\t<seconds>\\t<self seconds>` for each span name and
`counter\\t<span name>\\t<key>\\t<value>` for each counter
(twopaco_tpu_torch/cli/twopaco.py, trace.py). A program that prints none
(an older one) gives the readers nothing to read: they return None.

Under torch.profiler each span is also a user annotation of its name, on
the profiler's clock: annotations() takes them out of a profile, and
idle_gaps() names the device's idle gaps by them.

    python3 -m gpubench.spans --workload ecoli62.sort-r1 --seed 7 --builds 3

runs a cell's checked build and then --builds builds with no profiler and
--builds under it, each as the harness runs one, and prints the spans'
seconds a build, the request's tail outside the program (the build's wall
less its root span), the traced builds' idle gaps named by span, and the
recorder's cost a span with no profiler and under one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from gpubench import devtrace, readers

ROOT_SPAN = "twopaco"
OUTSIDE = "outside the program"


def span_table(stdout: str) -> tuple[dict, dict]:
    """One build's span and counter lines -> ({name: (count, seconds, self
    seconds)}, {(span name, key): value})."""
    spans, counters = {}, {}
    for line in stdout.splitlines():
        parts = line.split("\t")
        if len(parts) == 5 and parts[0] == "span":
            spans[parts[1]] = (int(parts[2]), float(parts[3]), float(parts[4]))
        elif len(parts) == 4 and parts[0] == "counter":
            counters[(parts[1], parts[2])] = float(parts[3])
    return spans, counters


def per_build(record: dict, value) -> float | None:
    """value(spans, counters) -> float or None, averaged over the record's
    builds that printed a span tree; None when none did, or value gave
    None for each."""
    got = []
    for b in record["builds"]:
        spans, counters = span_table(b["stdout"])
        if spans:
            v = value(spans, counters)
            if v is not None:
                got.append(v)
    return sum(got) / len(got) if got else None


def counter_reader(span: str, key: str):
    """A metric reader of one counter, averaged over the builds."""
    return lambda record: per_build(record, lambda _s, c: c.get((span, key)))


# ---- the spans on the profiler's clock ----------------------------------


def annotations(prof) -> list:
    """The program's spans in a profile: [[name, start, end], ...] of the
    host-side user annotations other than the harness's build ranges, in
    seconds from the first build range's start (devtrace.from_profiler's
    clock), sorted by start (an enclosing span before the spans it holds)."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events()
            if getattr(e, "is_user_annotation", False) and e.device_type != DeviceType.CUDA]
    t0 = min(e.time_range.start for e in host if e.name == devtrace.BUILD_RANGE)
    return sorted(([e.name, (e.time_range.start - t0) / 1e6, (e.time_range.end - t0) / 1e6]
                   for e in host if e.name != devtrace.BUILD_RANGE),
                  key=lambda x: (x[1], -x[2]))


def _depths(spans) -> list:
    """Each span's depth in the tree its intervals nest into (spans as
    annotations() sorts them; the program's spans nest, on one thread)."""
    depth, stack = [], []
    for _name, s, e in spans:
        while stack and stack[-1] <= s:
            stack.pop()
        depth.append(len(stack))
        stack.append(e)
    return depth


def idle_gaps(trace: dict, spans: list, top: int = 10):
    """devtrace.idle_gaps with the program's spans: [[name, seconds], ...]
    of the longest stretches of a traced build with no device operation,
    longest first. Gaps are cut at the builds' ends and at every span's
    start and end, so that each piece lies in one span and none of its
    children; a piece is named by the host operator that covers half of
    it, else by the deepest span that covers half of it, else "outside the
    program". With no spans: devtrace.idle_gaps."""
    if not spans:
        return devtrace.idle_gaps(trace, top)
    depth = _depths(spans)
    cuts = sorted({t for _n, s, e in spans for t in (s, e)})
    gaps = []
    for lo, hi in trace["builds"]:
        t = lo
        for s, e in devtrace.union(((s, e) for _n, s, e, _c in trace["device"]), lo,
                                   hi) + [[hi, hi]]:
            if s > t:
                inner = [c for c in cuts if t < c < s]
                gaps.extend(zip([t, *inner], [*inner, s]))
            t = max(t, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        name = devtrace._host_op(trace, s, e)
        if name == "no torch op":
            name = _deepest(spans, depth, s, e)
        out.append([name, e - s])
    return out


def _deepest(spans, depth, s: float, e: float) -> str:
    best, best_depth = OUTSIDE, -1
    for (name, a, b), d in zip(spans, depth):
        if a >= e:
            break
        if min(b, e) - max(a, s) >= 0.5 * (e - s) and d > best_depth:
            best, best_depth = name, d
    return best


# ---- the analysis run ------------------------------------------------------


def recorder_cost(n: int) -> float:
    """Nanoseconds a span costs the program (open and close, nested once)
    over n spans, with whatever profiler is running."""
    from twopaco_tpu_torch import trace

    t0 = time.perf_counter_ns()
    with trace.span("cost"):
        for _ in range(n):
            with trace.span("cost.inner"):
                pass
    return (time.perf_counter_ns() - t0) / n


def span_means(rows: list) -> dict:
    """{name: [mean seconds, mean self seconds, mean count]} over builds'
    span tables."""
    names = list(dict.fromkeys(n for spans, _c in rows for n in spans))
    return {n: [sum(s.get(n, (0, 0.0, 0.0))[i] for s, _c in rows) / len(rows)
                for i in (1, 2, 0)] for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--builds", type=int, default=3)
    p.add_argument("--out", default=None, help="also write the result as JSON here")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench import genome, harness, sink
    from twopaco_tpu_torch.cli import serve

    if not torch.cuda.is_available():
        print("gpubench.spans: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    work = tempfile.mkdtemp(prefix="gpubench-spans-")
    try:
        seqs = genome.config_genomes(config, args.seed)
        fasta = os.path.join(work, "input.fa")
        genome.write_fasta(fasta, seqs)
        del seqs
        runner = harness.Builder(["-k", str(config["k"]), *traffic["argv"]], fasta,
                                  sink.make_fifo(work), "cuda")
        serve.warm("cuda")
        checked = runner.run(keep=True)
        plain = [runner.run(expect=checked["data"]) for _ in range(args.builds)]
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            traced = [runner.run(expect=checked["data"], profile_range=True)
                      for _ in range(args.builds)]
            cost_profiled = recorder_cost(2000)
        cost_plain = recorder_cost(20000)
        tr = devtrace.from_profiler(prof)
        del prof
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = dict(card=harness.card_line(), workload=args.workload, seed=args.seed)
    for tag, builds in (("plain", plain), ("traced", traced)):
        rows = [span_table(b["stdout"]) for b in builds]
        roots = [s[ROOT_SPAN][1] for s, _c in rows]
        n_spans = [sum(v[0] for v in s.values()) for s, _c in rows]
        times_match = all(
            round(s[key][1], 3) == val for (s, _c), b in zip(rows, builds)
            for key, val in readers.time_keys(b["stdout"]).items() if key in s and key != "total")
        result[tag] = dict(
            ok=[b["rc"] == 0 and bool(b["same"]) for b in builds],
            wall_s=[b["wall_s"] for b in builds], root_s=roots,
            tail_s=[b["wall_s"] - r for b, r in zip(builds, roots)],
            spans_a_build=n_spans, time_lines_equal_span_sums=times_match,
            spans=span_means(rows),
            counters={f"{k[0]}.{k[1]}": sum(c.get(k, 0.0) for _s, c in rows) / len(rows)
                      for k in dict.fromkeys(k for _s, c in rows for k in c)})
    result["traced"]["busy_s"] = devtrace.busy_seconds(tr)
    result["traced"]["window_s"] = tr["span"][1] - tr["span"][0]
    result["traced"]["device_ops"] = devtrace.device_ops(tr)
    result["traced"]["idle_gaps"] = idle_gaps(tr, tr["spans"], top=16)
    result["traced"]["idle_gaps_without_spans"] = devtrace.idle_gaps(tr)
    spans_a_build = sum(result["plain"]["spans_a_build"]) / len(plain)
    result["recorder"] = dict(ns_a_span=cost_plain, ns_a_span_profiled=cost_profiled,
                              spans_a_build=spans_a_build,
                              ms_a_build=cost_plain * spans_a_build / 1e6,
                              ms_a_build_profiled=cost_profiled * spans_a_build / 1e6)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
