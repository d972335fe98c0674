"""sort_roofline: the round sort's (kernels/csrc/sort.cu) share of its
HBM roofline over the traced builds: the least time of its bytes (each
real record's k-mer words, payload and position read once and written
once, peaks.sort_bytes) at the card's peak bandwidth, over the device time
of the round sort's kernels by name. Those are sort.cu's digit histogram
and digit passes that read records (k_digit_hist<1|2>, k_onesweep<1|2,
*>) and its gather; occ_pack.cu's passes over bare u64 keys
(k_digit_hist<0>, k_onesweep<0, 0>) and the scratch memset are not
counted."""

import re

from gpubench import peaks

_ROUND_SORT = re.compile(r"\bk_digit_hist<[12]>|\bk_onesweep<[12], ?\d>|\bk_gather\b")


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    seconds = sum(e - s for name, s, e in trace["device"] if _ROUND_SORT.search(name))
    if seconds <= 0:
        return None
    n_builds = len(trace["builds"])
    need = n_builds * peaks.sort_bytes(record["records"], record["k"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * need / seconds
