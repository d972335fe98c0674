"""The metric readers on a recorded run: a build's log as the CLI prints
it, and a device trace."""

import pytest

from gpubench import devtrace, harness, peaks

# the log of a sort -r 4 build (the CLI's lines, as a run captures them)
LOG = """Engine = sort-join (cuda)
Vertex length = 31
Record slots = 249561088
Capacity = 2 words
Splitting the input kmers set (4 rounds, resident parts, block cap 557056)
Round 0, 0:1073741823
Round 0 seconds: build=0.0043 sort=0.0131 judge=0.0022 fetch=0.0009
True junctions = 0
Distinct k-mers = 62231105
Occurrences = 0
True marks count: 2
Distinct junctions = 0
Distinct junctions = 0
time\tread\t0.412
time\twindows\t0.006
time\tupload\t0.061
time\thist\t0.000
time\tpartition\t0.019
time\tbuild\t0.017
time\tsort\t0.052
time\tjudge\t0.009
time\tfetch\t0.004
time\tmerge\t0.001
time\temit\t0.002
time\temit_stub\t0.001
time\temit_write\t0.001
time\ttotal\t0.590

"""

KERNELS = [
    "void (anonymous namespace)::k_digit_hist<1>((anonymous namespace)::KeySrc, unsigned long)",
    "void (anonymous namespace)::k_onesweep<2, 1>((anonymous namespace)::PassArgs)",
    "void (anonymous namespace)::k_onesweep<2, 0>((anonymous namespace)::PassArgs)",
    "void (anonymous namespace)::k_onesweep<0, 0>((anonymous namespace)::PassArgs)",
    "void (anonymous namespace)::k_digit_hist<0>((anonymous namespace)::KeySrc, unsigned long)",
    "Memcpy HtoD (Pinned -> Device)",
]


def _record(trace=None):
    log2 = LOG.replace("time\tread\t0.412", "time\tread\t0.388")
    return dict(bases=248956422, sequences=1, k=31, records=248956392, setup_s=14.5,
                window_s=2.0, window_peak_bytes=3 << 30, trace=trace,
                builds=[dict(rc=0, ok=True, wall_s=1.0, stdout=LOG),
                        dict(rc=0, ok=True, wall_s=1.0, stdout=log2)])


def _trace():
    # two builds, [0, 1] and [1, 2] s; device busy [0.1, 0.2], [0.15, 0.3]
    # (overlapping: 0.2 s of union), [1.5, 1.6]; sort kernels 0.01 s each
    device = [["Memcpy HtoD (Pinned -> Device)", 0.1, 0.2],
              [KERNELS[1], 0.15, 0.3], [KERNELS[3], 1.5, 1.6]]
    for i, name in enumerate(KERNELS[:5]):
        device.append([name, 1.7 + 0.02 * i, 1.71 + 0.02 * i])
    host = [["aten::copy_", 0.35, 0.9], ["cudaLaunchKernel", 0.31, 0.32]]
    return dict(span=[0.0, 2.0], builds=[[0.0, 1.0], [1.0, 2.0]], device=device, host=host)


@pytest.mark.parametrize("name,want", [
    ("read_s", 0.4), ("upload_s", 0.067), ("rounds_s", 0.097), ("fetch_merge_s", 0.005),
    ("emit_s", 0.002), ("setup_s", 14.5), ("peak_device_gib", 3.0),
    ("window_mbases_per_s", 2 * 248956422 / 2.0 / 1e6),
])
def test_time_and_host_readers(name, want):
    assert harness.load_reader(name)(_record()) == pytest.approx(want)


def test_rate_counts_only_builds_with_the_checked_output():
    rec = _record()
    rec["builds"][1]["ok"] = False  # rc 0, other bytes
    assert harness.load_reader("window_mbases_per_s")(rec) == pytest.approx(248956422 / 2.0 / 1e6)


def test_readers_without_a_trace_return_nothing():
    for name in ("device_idle_pct", "sort_roofline"):
        assert harness.load_reader(name)(_record()) is None
    assert harness.load_reader("read_s")(dict(builds=[dict(stdout="no times")])) is None


def test_device_idle_and_busy():
    rec = _record(_trace())
    busy = 0.2 + 0.1 + 5 * 0.01
    assert devtrace.busy_seconds(rec["trace"]) == pytest.approx(busy)
    assert harness.load_reader("device_idle_pct")(rec) == pytest.approx(100 * (1 - busy / 2))


def test_sort_roofline_counts_the_round_sort_only():
    rec = _record(_trace())
    # the round sort's kernels: k_onesweep<2, 1> 0.15 s, then k_digit_hist<1>
    # and k_onesweep<2, 1>, <2, 0> 0.01 s each; not occ_pack's <0, 0> or hist<0>
    secs = 0.15 + 0.03
    need = 2 * rec["records"] * 2 * (4 * 2 + 12) / peaks.HBM_BYTES_PER_S
    assert harness.load_reader("sort_roofline")(rec) == pytest.approx(100 * need / secs)


def test_breakdown():
    tr = _trace()
    ops = devtrace.device_ops(tr, top=3)
    assert ops[0][0] == "k_onesweep<2, 1>" and ops[0][1] == pytest.approx(0.16)
    assert len(ops) == 3
    gaps = devtrace.idle_gaps(tr)
    # cut at the builds' ends: [0.3, 1.0] in the first, [1.0, 1.5] in the second
    assert [g[1] for g in gaps[:2]] == pytest.approx([0.7, 0.5])
    assert gaps[0][0] == "aten::copy_"
    assert gaps[1][0] == "no torch op"
    assert gaps == sorted(gaps, key=lambda g: -g[1])
    tr["host"] = [["cudaHostRegister", 1.0, 1.45]]
    assert devtrace.idle_gaps(tr)[1][0] == "cudaHostRegister"
    assert devtrace.short_name(KERNELS[0]) == "k_digit_hist<1>"


def test_union():
    assert devtrace.union([(0, 1), (0.5, 2), (3, 4), (5, 9)], 0.5, 6) == [[0.5, 2], [3, 4], [5, 6]]


def test_vertex_records_and_bytes():
    import numpy as np

    seqs = [np.frombuffer(b"ACGTNACGTACG", np.uint8), np.frombuffer(b"ACG", np.uint8),
            np.frombuffer(b"acgtac", np.uint8)]
    # k = 4: windows of the first without N: ACGT (0), ACGT (5), CGTA, GTAC, TACG
    assert peaks.vertex_records(seqs, 4) == 5 + 3
    assert peaks.sort_bytes(10, 25) == 10 * 2 * 20
    assert peaks.key_words(31) == 2 and peaks.key_words(33) == 3


def test_log_summary():
    got = harness.log_summary(LOG)
    assert got[0] == "Engine = sort-join (cuda)"
    assert any(g.startswith("Splitting the input kmers set (4 rounds") for g in got)
    assert sum(g.startswith("time\t") for g in got) == 14
