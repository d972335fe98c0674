"""The device trace of a traced window: torch.profiler's events turned
into the plain record the metric readers take, and the arithmetic over it
(the union of device time, the idle gaps and what the host did in them).

Times in the record are seconds from the first traced build's start, on
the profiler's clock."""

from __future__ import annotations

import re

BUILD_RANGE = "gpubench.build"


def short_name(name: str, width: int = 80) -> str:
    """A kernel's or operator's name without its namespaces and
    parameter list: 'void (anonymous namespace)::k_onesweep<2, 1>(...)'
    -> 'k_onesweep<2, 1>'."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:width]
    name = re.sub(r"^void ", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # cut the parameter list at depth 0
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def from_profiler(prof) -> dict:
    """The trace part of the record: {"span": [0, end], "builds": [[start,
    end], ...], "device": [[name, start, end], ...], "host": [[name,
    start, end], ...]}."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # the build ranges on the host's side; the profiler also marks each on
    # the device's timeline (from its first to its last device operation),
    # which is no device work and is left out
    ranges = sorted((e for e in events
                     if e.name == BUILD_RANGE and e.device_type != DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not ranges:
        raise RuntimeError("the profiler recorded no build range")
    t0 = ranges[0].time_range.start
    sec = (lambda us: (us - t0) / 1e6)
    device, host = [], []
    for e in events:
        if e.name == BUILD_RANGE or getattr(e, "is_user_annotation", False):
            continue
        item = [e.name, sec(e.time_range.start), sec(e.time_range.end)]
        (device if e.device_type == DeviceType.CUDA else host).append(item)
    builds = [[sec(r.time_range.start), sec(r.time_range.end)] for r in ranges]
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dict(span=[builds[0][0], builds[-1][1]], builds=builds, device=device, host=host)


def union(intervals, lo: float, hi: float):
    """The union of [start, end] intervals clipped to [lo, hi], merged and
    sorted: [[start, end], ...]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace: dict) -> float:
    lo, hi = trace["span"]
    return sum(e - s for s, e in union(((s, e) for _n, s, e in trace["device"]), lo, hi))


def device_ops(trace: dict, top: int = 10):
    """[[short name, total seconds], ...] of the device operations that
    took the most time, most first."""
    tot: dict[str, float] = {}
    for name, s, e in trace["device"]:
        key = short_name(name)
        tot[key] = tot.get(key, 0.0) + (e - s)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: dict, top: int = 10):
    """[[what the host did, seconds], ...] of the longest stretches of a
    traced build with no device operation, longest first (gaps are cut at
    the builds' ends, so that one build's tail and the next one's head
    are two). A gap is named by the host operator that covers most of it
    (its innermost, where several cover as much; "no torch op" where none
    covers half)."""
    gaps = []
    for lo, hi in trace["builds"]:
        t = lo
        for s, e in union(((s, e) for _n, s, e in trace["device"]), lo, hi):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_host_op(trace, s, e), e - s] for s, e in gaps[:top]]


def _host_op(trace: dict, s: float, e: float) -> str:
    best, best_key = None, None
    for name, hs, he in trace["host"]:
        if hs >= e:
            break
        ov = min(he, e) - max(hs, s)
        if ov <= 0:
            continue
        key = (ov, -(he - hs))
        if best_key is None or key > best_key:
            best, best_key = name, key
    if best is None or best_key[0] < 0.5 * (e - s):
        return "no torch op"
    return short_name(best, 48)
