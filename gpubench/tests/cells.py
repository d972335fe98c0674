"""Small cells for the CPU tests: a copy of the benchmark's files in a
temporary root, with a tiny configuration beside the real ones."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

from gpubench import harness

REPO = harness.ROOT
TINY = {"name": "tiny", "source": "test", "genomes": 4, "length": 6000, "snp_rate": 0.01,
        "n_rate": 0.001, "k": 25, "reduced": []}


def make_root(tmp: Path, config: dict = TINY, traffic: str = "sort-r4",
              cell: str | None = None) -> tuple[Path, str]:
    """A root holding BENCHMARK.json and gpubench/ as the repository has
    them, plus `config` (configs/<name>.json) and a cell of it under
    `traffic`, added as files and entries only. -> (root, cell name)"""
    root = tmp / "root"
    shutil.copytree(REPO / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = cell or f"{config['name']}.{traffic}"
    (root / "gpubench" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    bench["configs"].append({"name": config["name"], "source": "test",
                             "file": f"gpubench/configs/{config['name']}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": config["name"], "traffic": traffic,
                               "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, name


def run_cpu(root: Path, cell: str, seed: int = 7, seconds: float = 0.3, trace: bool = False):
    """One harness run of the cell on the CPU (the program's plain
    versions). -> (exit code, the result line as a dict or None, stderr)"""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, seconds, trace, device="cpu", root=root,
                     extra_argv=("--device", "cpu"), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    result = None
    if lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    return rc, result, err.getvalue()
