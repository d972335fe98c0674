"""The span readers (gpubench/spans.py and the five metrics that read it)
on a recorded build log, and the idle gaps named by the program's spans on
a synthetic trace."""

import pytest

from gpubench import devtrace, harness, spans

# the span and counter lines a build prints after its time lines
SPANS = """time\temit\t4.100
span\ttwopaco\t1\t7.000000\t0.050000
span\ttotal\t1\t6.500000\t0.010000
span\tpin.lock\t3\t0.300000\t0.300000
span\tpin.wait\t3\t0.020000\t0.020000
span\tpin.unlock\t3\t0.100000\t0.100000
span\temit_write\t1\t4.000000\t4.000000
counter\temit_write\tdecode_wait_s\t1.500000
counter\temit_write\tassemble_s\t1.200000
counter\temit_write\tsink_s\t1.100000
counter\temit_write\tbytes\t1527000000
"""


def _record(*stdouts):
    return dict(builds=[dict(rc=0, ok=True, wall_s=8.0, stdout=s) for s in stdouts])


@pytest.mark.parametrize("name,want", [
    ("build_self_s", (0.05 + 0.15) / 2), ("page_lock_s", (0.4 + 0.5) / 2),
    ("emit_decode_wait_s", (1.5 + 1.7) / 2), ("emit_assemble_s", 1.2),
    ("emit_sink_s", (1.1 + 0.9) / 2),
])
def test_span_readers(name, want):
    second = (SPANS.replace("7.000000\t0.050000", "7.000000\t0.150000")
              .replace("0.300000\t0.300000", "0.400000\t0.400000")
              .replace("decode_wait_s\t1.500000", "decode_wait_s\t1.700000")
              .replace("sink_s\t1.100000", "sink_s\t0.900000"))
    # a third build of an older program prints no spans: not averaged in
    rec = _record(SPANS, second, "time\temit\t4.000\n")
    assert harness.load_reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", ["build_self_s", "page_lock_s", "emit_decode_wait_s",
                                  "emit_assemble_s", "emit_sink_s"])
def test_span_readers_without_spans_return_nothing(name):
    assert harness.load_reader(name)(_record("time\temit\t4.000\n", "no lines")) is None


def test_page_lock_reads_zero_where_nothing_was_locked():
    no_pins = "\n".join(ln for ln in SPANS.splitlines() if "\tpin." not in ln)
    assert harness.load_reader("page_lock_s")(_record(no_pins)) == 0.0


def test_span_table():
    got, counters = spans.span_table(SPANS + "span\tbad line\n")
    assert got["pin.lock"] == (3, 0.3, 0.3) and len(got) == 6
    assert counters[("emit_write", "bytes")] == 1527000000.0


def _trace():
    # one build [0, 10]: device work [0.5, 1.0] and [1.1, 1.2]; a torch op
    # over [1.2, 1.5]
    device = [["k_records<2>", 0.5, 1.0, 0], ["Memcpy DtoH (Device -> Pinned)", 1.1, 1.2, 0]]
    host = [["aten::copy_", 1.2, 1.5], ["cudaLaunchKernel", 0.49, 0.5]]
    return dict(span=[0.0, 10.0], builds=[[0.0, 10.0]], device=device, host=host)


# the program's spans, sorted as annotations() sorts them: the root from
# 0.1 to 9.0; its children read [0.1, 0.4], fetch [1.1, 2.0] (with
# pin.lock [1.5, 1.9] in it), emit [2.0, 8.0] (emit_write [2.5, 8.0])
SPAN_TREE = [["twopaco", 0.1, 9.0], ["read", 0.1, 0.4], ["fetch", 1.1, 2.0],
             ["pin.lock", 1.5, 1.9], ["emit", 2.0, 8.0], ["emit_write", 2.5, 8.0]]


def test_idle_gaps_named_by_spans():
    gaps = spans.idle_gaps(_trace(), SPAN_TREE, top=20)
    assert gaps == sorted(gaps, key=lambda g: -g[1])
    got = sorted((name, round(sec, 6)) for name, sec in gaps)
    # cut at every span's start and end
    assert got == sorted([
        ("outside the program", 0.1),  # [0, 0.1]: before the root
        ("read", 0.3),                 # [0.1, 0.4]
        ("twopaco", 0.1),              # [0.4, 0.5]: the root's self time
        ("twopaco", 0.1),              # [1.0, 1.1]
        ("aten::copy_", 0.3),          # [1.2, 1.5]: a torch op covers it
        ("pin.lock", 0.4),             # [1.5, 1.9]: the deepest span over it
        ("fetch", 0.1),                # [1.9, 2.0]
        ("emit", 0.5),                 # [2.0, 2.5]
        ("emit_write", 5.5),           # [2.5, 8.0]
        ("twopaco", 1.0),              # [8.0, 9.0]
        ("outside the program", 1.0),  # [9.0, 10]: the request's tail
    ])
    assert "no torch op" not in {name for name, _s in gaps}


def test_idle_gaps_without_spans_as_before():
    tr = _trace()
    assert spans.idle_gaps(tr, []) == devtrace.idle_gaps(tr)


def test_depths_follow_nesting():
    assert spans._depths(SPAN_TREE) == [0, 1, 1, 2, 1, 2]
