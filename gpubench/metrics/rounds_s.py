"""rounds_s: seconds a build spends in the sort engine's rounds
(passes/sortpipe.py: histogram, partition, records, sort, judge): the
CLI's `time hist` + `partition` + `build` + `sort` + `judge`, averaged
over the traced builds."""

from gpubench.readers import phase_seconds


def read(record):
    return phase_seconds(record, ("hist", "partition", "build", "sort", "judge"))
