"""device_idle_pct: the share of the traced builds' wall time in which
no operation ran on a card, averaged over the cell's cards: 100 x (1 -
devtrace.busy_seconds, the mean over the cards of each card's union of its
device events' intervals, / the span from the first traced build's start
to the last's end), from torch.profiler's trace."""

from gpubench import devtrace


def read(record):
    trace = record.get("trace")
    if not trace or not trace["device"]:
        return None
    lo, hi = trace["span"]
    return 100.0 * (1.0 - devtrace.busy_seconds(trace) / (hi - lo))
