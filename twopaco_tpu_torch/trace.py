"""The port's span recorder: one tree of named, timed spans a build.

    with trace.span("fetch", r=0) as sp:
        ...
        sp.add("bytes", n)

A span records its id, its parent, its name, its start and end (on
time.perf_counter_ns), the thread that opened it, its attrs and its
counters (Span.add). Its parent is the innermost span open on the same
thread, or the `parent=` given (work handed to another thread). A span
opened with no parent is a root: cli/twopaco.py main opens "twopaco" for
each CLI run and each daemon request, and an engine called on its own
opens its "total" as a root. A tree is held in memory while its root is
open; when the root closes, its spans become last_build(), in place of
the previous tree's, so nothing grows across a daemon's requests.

While torch.profiler records, each span is also a
torch.profiler.record_function range of its name, so it lies in the
profiler's trace, on the profiler's clock, beside the device's work. With
no profiler recording, the recorder makes no profiler call.

Phase times (RunStats.timings, the CLI's `time` lines, a round's `t_*`)
are sums of span durations by name (totals).
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_ids = itertools.count(1)
_local = threading.local()
# the finished tree of the root that closed last; the recorder is
# process-wide, like a logger: a span needs no handle passed down to it
_last: tuple = ()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One timed stretch of the program; a context manager. start and end
    are perf_counter_ns readings (end None while open)."""

    __slots__ = ("id", "parent", "name", "attrs", "counters", "thread", "start", "end",
                 "_tree", "_range")

    def __init__(self, name: str, parent: Span | None, attrs: dict):
        self.id = next(_ids)
        self.parent = parent
        self.name = name
        self.attrs = attrs
        self.counters: dict = {}
        self.thread = threading.get_ident()
        self.start = self.end = None
        self._tree = [] if parent is None else parent._tree
        self._range = None

    def add(self, key: str, value) -> None:
        """Accumulate a counter on this span."""
        self.counters[key] = self.counters.get(key, 0) + value

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> Span:
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        _stack().append(self)
        self._tree.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _last
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.parent is None:
            _last = tuple(self._tree)


def span(name: str, parent: Span | None = None, **attrs) -> Span:
    """A span named `name` under `parent` (default: the innermost span open
    on this thread; none: a root)."""
    return Span(name, parent if parent is not None else current(), attrs)


def current() -> Span | None:
    """The innermost span open on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def last_build() -> tuple:
    """The spans of the tree whose root closed last, root first, in the
    order they opened."""
    return _last


def descendants(sp: Span) -> list:
    """sp's descendants, in the order they opened (a parent opens before
    its children)."""
    inside = {sp.id}
    out = []
    for s in sp._tree:
        if s.parent is not None and s.parent.id in inside:
            inside.add(s.id)
            out.append(s)
    return out


def totals(sp: Span) -> dict:
    """{name: seconds} of sp's finished descendants, summed by name."""
    out: dict = {}
    for s in descendants(sp):
        if s.end is not None:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def self_seconds(sp: Span, children) -> float:
    """sp's duration less the part of it that its children cover."""
    covered, t = 0, sp.start
    for a, b in sorted((max(c.start, sp.start), min(c.end, sp.end)) for c in children):
        a = max(a, t)
        if b > a:
            covered += b - a
            t = b
    return (sp.end - sp.start - covered) / 1e9


def by_name(spans) -> dict:
    """{name: {"n", "total", "self", "counters"}} of finished spans, in the
    order their names first opened: the count, the summed and the summed
    self seconds, and the counters summed."""
    kids: dict = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent.id, []).append(s)
    out: dict = {}
    for s in spans:
        if s.end is None:
            continue
        row = out.setdefault(s.name, dict(n=0, total=0.0, self=0.0, counters={}))
        row["n"] += 1
        row["total"] += s.seconds
        row["self"] += self_seconds(s, [c for c in kids.get(s.id, ()) if c.end is not None])
        for key, val in s.counters.items():
            row["counters"][key] = row["counters"].get(key, 0) + val
    return out
