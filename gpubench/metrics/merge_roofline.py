"""merge_roofline: the device merge's (kernels/csrc/merge.cu) share of its
HBM roofline over the traced builds: the least time of its bytes (the
junctions' table rows and the occurrences' keys read once and written
once, peaks.merge_bytes, counted from the plain reference's junctions and
occurrences) at the card's peak bandwidth, over the device time of
merge.cu's kernels by name (k_merge_split, k_merge_tile and, past four
entries, k_merge_compose). A build that merges no entries on the card
runs none of them: nothing to read."""

import re

from gpubench import peaks

_MERGE = re.compile(r"\bk_merge_(?:split|tile|compose)\b")


def read(record):
    trace = record.get("trace")
    if not trace or "junctions" not in record:
        return None
    seconds = sum(e - s for name, s, e, _card in trace["device"] if _MERGE.search(name))
    if seconds <= 0:
        return None
    need = len(trace["builds"]) * peaks.merge_bytes(
        record["junctions"], record["occurrences"], record["k"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * need / seconds
