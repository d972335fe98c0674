"""The readers and the breakdown on one fixed traced record: the trace as
devtrace.from_profiler gives it (now with the program's spans), the logs
of two builds with their time, span and counter lines. Every reader the
benchmark had reads what it read before the spans joined the trace (the
values below were read by the parent tree's readers on this record); only
the breakdown's idle gaps change, named by span."""

import pytest

from gpubench import devtrace, harness

LOG = """Engine = sort-join (cuda)
Splitting the input kmers set (4 rounds, resident parts, block cap 557056)
Round 0 seconds: build=0.0043 sort=0.0131 judge=0.0022 fetch=0.0009
Distinct k-mers = 1000
Occurrences = 500
Round 1 seconds: build=0.0041 sort=0.0129 judge=0.0020 fetch=0.0008
Distinct k-mers = 1200
Occurrences = 700
time\tread\t0.500
time\twindows\t0.010
time\tupload\t0.090
time\thist\t0.001
time\tpartition\t0.020
time\tbuild\t0.017
time\tsort\t0.052
time\tjudge\t0.009
time\tfetch\t0.300
time\tmerge\t0.150
time\temit\t2.100
time\temit_stub\t0.010
time\temit_write\t2.000
time\ttotal\t3.300
span\ttwopaco\t1\t3.400000\t0.020000
span\ttotal\t1\t3.300000\t0.010000
span\tread\t1\t0.500000\t0.500000
span\tfetch\t2\t0.300000\t0.100000
span\tpin.lock\t3\t0.200000\t0.200000
span\tpin.unlock\t3\t0.050000\t0.050000
span\tmerge\t1\t0.150000\t0.150000
span\temit\t1\t2.100000\t0.100000
span\temit_write\t1\t2.000000\t2.000000
counter\temit_write\tdecode_wait_s\t0.900000
counter\temit_write\tassemble_s\t0.700000
counter\temit_write\tsink_s\t0.400000
"""

SORT = "void (anonymous namespace)::k_onesweep<2, 1>((anonymous namespace)::PassArgs)"
MERGE_TILE = "void (anonymous namespace)::k_merge_tile<2>((anonymous namespace)::TileArgs)"
MERGE_SPLIT = "void (anonymous namespace)::k_merge_split<2>((anonymous namespace)::SplitArgs)"


def _build_spans(t):
    """One build's spans from t on, as annotations() sorts them."""
    return [["twopaco", t + 0.05, t + 3.45], ["total", t + 0.1, t + 3.4],
            ["read", t + 0.1, t + 0.6], ["fetch", t + 0.7, t + 1.0],
            ["pin.lock", t + 0.75, t + 0.95], ["merge", t + 1.0, t + 1.15],
            ["emit", t + 1.3, t + 3.4], ["emit_write", t + 1.4, t + 3.4]]


def _trace():
    device = []
    for t in (0.0, 4.0):
        device += [["Memcpy HtoD (Pinned -> Device)", t + 0.6, t + 0.65, 0],
                   [SORT, t + 0.65, t + 0.7, 0],
                   ["Memcpy DtoH (Device -> Pinned)", t + 0.95, t + 1.0, 0],
                   [MERGE_SPLIT, t + 1.05, t + 1.051, 0], [MERGE_TILE, t + 1.051, t + 1.06, 0]]
    host = [["cudaLaunchKernel", 0.64, 0.65], ["aten::copy_", 4.6, 4.62]]
    return dict(span=[0.0, 7.6], builds=[[0.0, 3.6], [4.0, 7.6]], device=device, host=host,
                spans=_build_spans(0.0) + _build_spans(4.0), cards=1)


def record():
    return dict(bases=285_200_000, sequences=62, k=25, records=2_000_000, setup_s=20.5,
                window_s=7.6, window_peak_bytes=9 << 30, trace=_trace(),
                junctions=2_500_000, occurrences=127_000_000,
                builds=[dict(rc=0, ok=True, wall_s=3.6, stdout=LOG),
                        dict(rc=0, ok=True, wall_s=3.6, stdout=LOG.replace(
                            "time\tread\t0.500", "time\tread\t0.460"))])


# every metric of BENCHMARK.json before merge_roofline, read by the parent
# tree's readers on record() without its trace's "spans"
BEFORE = {
    "build_self_s": 0.02, "device_idle_pct": 95.78947368421052, "emit_assemble_s": 0.7,
    "emit_decode_wait_s": 0.9, "emit_s": 2.1, "emit_sink_s": 0.4,
    "fetch_merge_s": 0.44999999999999996, "page_lock_s": 0.25, "peak_device_gib": 9.0,
    "read_s": 0.48, "rounds_s": 0.099, "setup_s": 20.5, "sort_roofline": 0.047761194029850865,
    "upload_s": 0.09999999999999999, "window_mbases_per_s": 75.05263157894737,
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_readers_read_what_they_read_before(name):
    assert harness.load_reader(name)(record()) == BEFORE[name]


def test_merge_roofline():
    rec = record()
    # merge.cu's kernels: 0.01 s a build; the bytes: rows and keys read and written once
    need = 2 * (2 * 2_500_000 * 8 + 2 * 127_000_000 * 8) / 3.35e12
    assert harness.load_reader("merge_roofline")(rec) == pytest.approx(100 * need / 0.02)
    rec["trace"]["device"] = [e for e in rec["trace"]["device"] if "merge" not in e[0]]
    assert harness.load_reader("merge_roofline")(rec) is None  # no merge on the card
    assert harness.load_reader("merge_roofline")(dict(record(), trace=None)) is None


def test_breakdown_names_the_gaps_by_span():
    tr = _trace()
    got = harness.breakdown(tr)
    assert got["device_ops"] == devtrace.device_ops(tr)
    gaps = got["idle_gaps"]
    assert len(gaps) == 10 and gaps == sorted(gaps, key=lambda g: -g[1])
    assert "no torch op" not in {name for name, _s in gaps}
    # the longest: the emit's write, 1.4 to 3.4 s of each build
    assert gaps[0][0] == gaps[1][0] == "emit_write"
    assert gaps[0][1] == pytest.approx(2.0)
    assert [name for name, _s in gaps[2:6]] == ["read", "read", "pin.lock", "pin.lock"]
    # the rest lie in the span `total` or in the request's tail outside the root
    assert {name for name, _s in gaps[6:]} == {"total", "outside the program"}
    # without spans the gaps are named as before: by a torch op or none
    old = harness.breakdown({**tr, "spans": []})["idle_gaps"]
    assert old == devtrace.idle_gaps(tr)
    assert old[0][0] == "no torch op"


def test_span_summary():
    lines = harness.span_summary(record()["builds"])
    assert lines[0] == "spans, mean seconds / self seconds a build over 2 builds:"
    assert lines[1] == "  span twopaco 3.4000 / 0.0200 (1 a build)"
    assert "  span pin.lock 0.2000 / 0.2000 (3 a build)" in lines
    assert lines[-1] == "  outside the root 'twopaco': 0.2000 s a build"
    assert harness.span_summary([dict(rc=0, wall_s=1.0, stdout="no spans")]) == []


def test_rounds_summary():
    assert harness.rounds_summary(LOG) == (
        "rounds: 2; Distinct k-mers a round: max 1200, mean 1100.0; "
        "Occurrences a round: max 700, mean 600.0")
