"""Helpers the metric readers (metrics/<name>.py) share."""

from __future__ import annotations


def time_keys(stdout: str) -> dict[str, float]:
    """The CLI's `time\\t<key>\\t<seconds>` lines of one build's log."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split("\t")
        if len(parts) == 3 and parts[0] == "time":
            out[parts[1]] = float(parts[2])
    return out


def phase_seconds(record: dict, keys: tuple[str, ...]) -> float | None:
    """The sum of the time keys a build reports among `keys`, averaged
    over the record's builds that logged any of them; None when none
    did."""
    sums = []
    for b in record["builds"]:
        got = time_keys(b["stdout"])
        if any(key in got for key in keys):
            sums.append(sum(got.get(key, 0.0) for key in keys))
    return sum(sums) / len(sums) if sums else None
