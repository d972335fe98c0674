"""The port's span recorder (twopaco_tpu_torch/trace.py) and the CLI's
lines read from it: the tree, threads, counters, the `time` keys as span
sums in every engine, the daemon's requests, and the profiler's ranges."""

import json
import os
import threading
import time

import pytest
import torch

from twopaco_tpu_torch import trace
from twopaco_tpu_torch.cli import serve
from twopaco_tpu_torch.cli.twopaco import main as port_main

FA = os.path.join(os.path.dirname(__file__), "golden", "example.fa")


def _fields(text: str, tag: str) -> list:
    """The tab-separated fields after `tag` of the CLI's `tag` lines."""
    return [ln.split("\t")[1:] for ln in text.splitlines() if ln.startswith(tag + "\t")]


def _build(tmp_path, *flags):
    out = str(tmp_path / "out.dbg")
    argv = ["-k", "11", "-f", "14", *flags, "--device", "cpu", FA, "-o", out]
    return port_main(argv), out


def test_tree_parents_and_one_root():
    with trace.span("a", x=1) as a:
        with trace.span("b") as b:
            time.sleep(0.002)
        with trace.span("c") as c:
            with trace.span("d") as d:
                time.sleep(0.002)
            c.add("n", 2)
    spans = trace.last_build()
    assert spans == (a, b, c, d) and a.attrs == {"x": 1}
    assert [s.parent for s in spans] == [None, a, a, c]
    assert trace.descendants(a) == [b, c, d] and trace.descendants(c) == [d]
    got = trace.totals(a)
    assert set(got) == {"b", "c", "d"} and got["c"] >= got["d"] >= 0.002
    # a's self time: its duration less what b and c cover
    want = a.seconds - (b.end - b.start + c.end - c.start) / 1e9
    assert trace.self_seconds(a, [b, c]) == pytest.approx(want, abs=1e-9)
    rows = trace.by_name(spans)
    assert list(rows) == ["a", "b", "c", "d"]
    assert rows["c"]["counters"] == {"n": 2} and rows["a"]["n"] == 1
    assert rows["a"]["self"] == pytest.approx(want, abs=1e-9)


def test_span_opened_on_a_thread_takes_its_parent():
    seen = {}

    def work(parent):
        with trace.span("worker", parent=parent) as w:
            with trace.span("inner") as i:  # the worker's own stack
                seen.update(w=w, i=i)

    with trace.span("root") as root:
        t = threading.Thread(target=work, args=(root,))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with trace.span("after") as after:
            pass
    spans = trace.last_build()
    assert set(spans) == {root, seen["w"], seen["i"], after}
    assert seen["w"].parent is root and seen["i"].parent is seen["w"]
    assert after.parent is root  # the thread's spans leave this stack alone
    assert seen["w"].thread != root.thread


def test_counters_accumulate_on_their_span():
    with trace.span("r") as r:
        r.add("bytes", 12)
        r.add("bytes", 30)
        r.add("wait_s", 0.25)
        r.add("wait_s", 0.5)
    assert r.counters == {"bytes": 42, "wait_s": 0.75}
    assert trace.by_name(trace.last_build())["r"]["counters"] == {"bytes": 42, "wait_s": 0.75}


@pytest.mark.parametrize("flags", [
    ("-r", "1"), ("-r", "3"), ("--tpu-engine", "bloom", "-r", "2"), ("--tpu-engine", "dist"),
], ids=["sort-r1", "sort-r3", "bloom", "dist"])
def test_time_keys_are_span_sums(tmp_path, capsys, flags):
    rc, out = _build(tmp_path, *flags)
    assert rc == 0
    text = capsys.readouterr().out
    spans = trace.last_build()
    root = spans[0]
    assert root.name == "twopaco" and root.parent is None
    assert sum(s.parent is None for s in spans) == 1
    (total,) = [s for s in spans if s.name == "total"]
    assert total.parent is root
    rows = trace.by_name(spans)
    times = {f[0]: f[1] for f in _fields(text, "time")}
    assert times.pop("total") == f"{total.seconds:.3f}"
    for name, val in times.items():
        want = rows[name]["total"] if name in rows else 0.0
        assert val == f"{want:.3f}", name
    # each round's log line from its round span
    for rs in (s for s in spans if s.name == "round"):
        t = trace.totals(rs)
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"Round {rs.attrs['r']} seconds:"))
        for key, val in (kv.split("=") for kv in line.split(": ")[1].split()):
            assert val == f"{t.get(key, 0.0):.4f}", (rs.attrs, key)
    # the span and counter lines, printed once the root has closed
    printed = {f[0]: f[1:] for f in _fields(text, "span")}
    assert list(printed) == list(rows) and "report" in printed
    for name, (n, tot, self_s) in printed.items():
        assert int(n) == rows[name]["n"] and tot == f"{rows[name]['total']:.6f}"
        assert self_s == f"{rows[name]['self']:.6f}"
    counters = {(f[0], f[1]): f[2] for f in _fields(text, "counter")}
    assert int(counters[("emit_write", "bytes")]) == os.path.getsize(out)
    for key in ("decode_wait_s", "assemble_s", "sink_s"):
        assert 0 <= float(counters[("emit_write", key)]) <= rows["emit_write"]["total"]


def test_daemon_requests_keep_one_tree_each(tmp_path, capsys):
    argv = ["-k", "11", "-f", "20", "--device", "cpu", FA, "-o", str(tmp_path / "o.dbg")]
    assert serve._dispatch("twopaco", argv) == 0
    first = trace.last_build()
    assert serve._dispatch("twopaco", argv) == 0
    second = trace.last_build()
    capsys.readouterr()
    assert first[0].name == second[0].name == "twopaco"
    assert not set(first) & set(second)
    assert min(s.id for s in second) > max(s.id for s in first)
    assert [s.name for s in first] == [s.name for s in second]
    assert all(s.parent is None or s.parent in second for s in second)


def test_spans_are_profiler_ranges_only_under_a_profiler(tmp_path, monkeypatch, capsys):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _build(tmp_path, "-r", "2")[0] == 0
    names = {e.name for e in prof.events()}
    assert {s.name for s in trace.last_build()} <= names
    assert {"twopaco", "total", "read", "upload", "round", "sort", "emit_write"} <= names
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    assert _build(tmp_path, "-r", "2")[0] == 0
    assert calls == []
    capsys.readouterr()


def test_tpu_profile_writes_one_trace_with_the_spans(tmp_path, capsys):
    prof_dir = tmp_path / "prof"
    assert _build(tmp_path, "-r", "2", "--tpu-profile", str(prof_dir))[0] == 0
    path = prof_dir / "twopaco.trace.json"
    assert f"Profile trace = {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"twopaco", "total", "read", "windows", "upload", "hist", "round", "build", "sort",
            "judge", "fetch", "merge", "emit", "emit_stub", "emit_write", "report"} <= ranges
    assert any(e.get("cat") == "cpu_op" for e in events)
