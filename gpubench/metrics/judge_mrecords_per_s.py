"""judge_mrecords_per_s: the judge's rate over the sort engine's rounds
(passes/judge.py, kernels/csrc/judge.cu, with the occurrences' sort that
finishes a round): the real records the build's `judge` spans count (their
`records` counter), over those spans' seconds, in millions a second,
averaged over the traced builds. A program whose judge spans carry no
`records` counter gives nothing to read."""

from gpubench.spans import per_build


def _rate(spans, counters):
    records = counters.get(("judge", "records"))
    seconds = spans["judge"][1] if "judge" in spans else 0.0
    if records is None or seconds <= 0:
        return None
    return records / seconds / 1e6


def read(record):
    return per_build(record, _rate)
