"""The port on the reference's own example input.

tests/golden/example.fa is the reference's example.fa rebuilt from the
two P paths of tests/golden/example_k11.gfa1: each path's segments,
reverse-complemented where the path says '-', joined over their k = 11
overlaps (headers >1 and >2; 420 and 490 bases). The junction positions
the port writes must equal the reference run's (example_k11.dbg,
example_k25.seq), in one round and in three, and so must the grouping
of the positions by junction id (the raw ids differ: the reference
numbers junctions in a random order).
"""

import os

import numpy as np
import pytest

from twopaco_tpu_torch.io import fasta, junctions
from twopaco_tpu_torch.passes.pipeline import PipelineConfig
from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
EXAMPLE_FA = os.path.join(GOLDEN, "example.fa")


def _golden(k):
    if k == 11:
        return junctions.read_junctions(os.path.join(GOLDEN, "example_k11.dbg"))
    want = np.loadtxt(os.path.join(GOLDEN, "example_k25.seq"), dtype=np.int64)
    return want[:, 0], want[:, 1], want[:, 2]


def _groups(chrs, pos, ids):
    g = {}
    for c, p, i in zip(chrs, pos, ids):
        g.setdefault(int(i), set()).add((int(c), int(p)))
    return sorted(sorted(v) for v in g.values())


def _spell(path_steps, seg, k=11):
    comp = str.maketrans("ACGT", "TGCA")
    s = ""
    for st in path_steps:
        body = seg[st[:-1]]
        if st[-1] == "-":
            body = body.translate(comp)[::-1]
        assert not s or s[-k:] == body[:k]
        s = body if not s else s + body[k:]
    return s


def test_example_fa_is_the_gfa_paths():
    seg, paths = {}, {}
    with open(os.path.join(GOLDEN, "example_k11.gfa1")) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if fields[0] == "S" and fields[2] != "*":
                seg[fields[1]] = fields[2]
            elif fields[0] == "P":
                paths[fields[1]] = fields[2].split(",")
    records = [(h, "".join("ACGTN"[c] for c in codes))
               for h, codes in fasta.read_fasta(EXAMPLE_FA)]
    assert [h for h, _ in records] == ["1", "2"]
    assert [len(s) for _, s in records] == [420, 490]
    for h, s in records:
        assert s == _spell(paths[h], seg)


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("rounds", [1, 3])
def test_example_positions_and_groups(tmp_path, k, rounds):
    out = str(tmp_path / "o.dbg")
    cfg = PipelineConfig(k=k, rounds=rounds, positions_per_row=256, rows_per_batch=4)
    enum = build_junctions_sorted([EXAMPLE_FA], cfg, out, device="cpu")
    assert len(enum.stats.rounds) == rounds
    chrs, pos, ids = junctions.read_junctions(out)
    want_c, want_p, want_i = _golden(k)
    np.testing.assert_array_equal(chrs, want_c)
    np.testing.assert_array_equal(pos, want_p)
    assert _groups(chrs, pos, ids) == _groups(want_c, want_p, want_i)
