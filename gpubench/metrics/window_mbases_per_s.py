"""window_mbases_per_s: the input bases of every build the window completed
with the checked build's output, in millions, over the window's seconds (the
first build's start to the last build's end, host clock). A build that
failed or wrote other bytes is not counted. A per-layer metric of the whole
build: read in the traced run, it carries no bound (PERF.md §2 says why)."""


def read(record):
    done = sum(b["ok"] for b in record["builds"])
    return record["bases"] * done / record["window_s"] / 1e6
