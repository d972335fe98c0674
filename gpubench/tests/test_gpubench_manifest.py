"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, and every file it names found under gpubench/."""

import json
import re

import pytest

from gpubench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    harness.check_chips(BENCH)


def _manifest(cells: int, four: int) -> dict:
    return {"workloads": [{"name": f"c{i}", "chips": 4 if i < four else 1}
                          for i in range(cells)]}


@pytest.mark.parametrize("cells,four", [(1, 1), (3, 1), (4, 1), (8, 2), (11, 2), (24, 6)])
def test_four_chip_cells_up_to_the_cap(cells, four):
    harness.check_chips(_manifest(cells, four))
    harness.check_chips(_manifest(cells, 0))


@pytest.mark.parametrize("cells,four", [(2, 2), (7, 2), (8, 3), (24, 7)])
def test_four_chip_cells_over_the_cap(cells, four):
    with pytest.raises(ValueError, match="ask for 4 chips"):
        harness.check_chips(_manifest(cells, four))


@pytest.mark.parametrize("chips", [0, 2, 3, 8, True, "1"])
def test_chips_other_than_1_or_4(chips):
    bench = _manifest(4, 0)
    bench["workloads"][2]["chips"] = chips
    with pytest.raises(ValueError, match="chips must be 1 or 4"):
        harness.check_chips(bench)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"peak_device_gib", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or m["unit"] == "%":
            assert m["source"] == "device_trace"


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_every_cell_reports_enough(cell):
    got = harness.load_cell(cell)
    names = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert got["per_layer"]
    assert all(m["moves"] in names for m in got["per_layer"])
