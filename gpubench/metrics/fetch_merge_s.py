"""fetch_merge_s: seconds a build spends fetching the rounds' entries and
merging them (sortpipe.fetch_entry, passes/merge.py, hostmem.py): the
CLI's `time fetch` + `merge`, averaged over the traced builds."""

from gpubench.readers import phase_seconds


def read(record):
    return phase_seconds(record, ("fetch", "merge"))
