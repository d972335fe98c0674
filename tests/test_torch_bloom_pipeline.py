"""The port's Bloom engine end to end on the CPU (the plain versions):
its .dbg must be byte-identical to twopaco_tpu's build_junctions(engine=
"bloom") and to the port's sort engine, in every layout and round count;
and it must hold against the naive oracle, through the mask spill, a
checkpoint resume, the CLI and the reference's example goldens."""

import os

import numpy as np
import pytest

from twopaco_tpu import dna as jdna
from twopaco_tpu.cli.twopaco import main as jax_main
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import build_junctions as jax_build
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.cli.twopaco import main as port_main
from twopaco_tpu_torch.io import junctions
from twopaco_tpu_torch.passes import bloompipe
from twopaco_tpu_torch.passes.pipeline import (
    INVALID_VERTEX,
    PipelineConfig,
    build_junctions,
    config_from_jax,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _genomes(seed, length=2500, n=4, rate=0.03):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [base] + [oracle.mutate_sequence(rng, base, rate, 0.1) for _ in range(n - 1)]


def _seqs(texts):
    return [(i, jdna.encode(s)) for i, s in enumerate(texts)]


def _jcfg(k, layout="auto", rounds=1, **kw):
    return JaxConfig(k=k, filter_bits=kw.pop("filter_bits", 20), rounds=rounds, layout=layout,
                     engine="bloom", positions_per_row=256, rows_per_batch=4, **kw)


def _port(tmp_path, cfg, name, sequences=None, paths=None, **kw):
    out = str(tmp_path / name)
    enum = build_junctions(paths, cfg, out, sequences=sequences, device="cpu", **kw)
    return open(out, "rb").read(), enum


def _three_ways(tmp_path, jcfg, sequences):
    """-> (JAX Bloom bytes, port Bloom bytes, port sort bytes, port enum)."""
    jout = str(tmp_path / "jax.dbg")
    jax_build(None, jcfg, out_path=jout, sequences=sequences)
    cfg = config_from_jax(jcfg)
    bloom_b, enum = _port(tmp_path, cfg, "bloom.dbg", sequences)
    sort_b, _ = _port(tmp_path, PipelineConfig(**{**cfg.__dict__, "engine": "sort"}),
                      "sort.dbg", sequences)
    return open(jout, "rb").read(), bloom_b, sort_b, enum


@pytest.mark.parametrize("layout,rounds,k", [
    ("byte", 1, 25), ("bit", 1, 25), ("block", 1, 25), ("byte", 3, 9),
    ("bit", 2, 7), ("block", 3, 101), ("byte", 2, 101), ("bit", 3, 25),
    ("block", 2, 9), ("auto", 1, 7),
])
def test_bloom_byte_identical(tmp_path, layout, rounds, k):
    texts = _genomes(k + rounds, rate=0.01 if k > 50 else 0.03)
    jb, bb, sb, enum = _three_ways(tmp_path, _jcfg(k, layout, rounds), _seqs(texts))
    assert jb == bb == sb and len(bb) > 0
    assert len(enum.stats.rounds) == rounds and enum.vertices_count > 0
    assert all(r["false_positives"] >= 0 for r in enum.stats.rounds)


def test_bloom_abundance_byte_identical(tmp_path):
    texts = _genomes(5, n=6)
    jb, bb, sb, enum = _three_ways(tmp_path, _jcfg(11, abundance=3), _seqs(texts))
    assert jb == bb == sb
    _jb, _bb, _sb, unlimited = _three_ways(tmp_path, _jcfg(11), _seqs(texts))
    assert enum.vertices_count < unlimited.vertices_count  # the limit dropped junctions


@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("rounds", [1, 3])
def test_bloom_differential_vs_oracle(tmp_path, k, rounds):
    """The oracle sweep of tests/test_pipeline.py:41 through the port."""
    rng = np.random.default_rng(1234 + k + rounds)
    base = oracle.generate_sequence(rng, 900)
    texts = [base] + [oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(3)]
    _b, enum = _port(tmp_path, config_from_jax(_jcfg(k, rounds=rounds)), "o.dbg", _seqs(texts))
    junc, want = oracle.find_junctions_naively(texts, k)
    chrs, pos, _ids = junctions.read_junctions(str(tmp_path / "o.dbg"))
    got = [np.zeros(len(s), bool) for s in texts]
    for c, p in zip(chrs, pos):
        got[c][p] = True
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(enum.get_id(v) != INVALID_VERTEX for v in junc)


def test_bloom_mask_spill_byte_identical(tmp_path, monkeypatch):
    """TWOPACO_MASK_SPILL_BYTES=1 writes every round's masks to a file in
    tmpdir (as tests/test_pipeline.py:60); pass 4 reads them back and the
    bytes do not change; the files are removed."""
    texts = _genomes(77, length=900, n=3, rate=0.05)
    cfg = config_from_jax(_jcfg(9, rounds=3))
    resident, _ = _port(tmp_path, cfg, "resident.dbg", _seqs(texts))
    saved = []
    np_save = np.save
    monkeypatch.setattr(np, "save", lambda path, arr: (saved.append(path), np_save(path, arr)))
    monkeypatch.setenv("TWOPACO_MASK_SPILL_BYTES", "1")
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    spilled, _ = _port(tmp_path, cfg, "spilled.dbg", _seqs(texts), tmpdir=str(spill_dir))
    assert spilled == resident
    assert len(saved) == 3 and all(p.startswith(str(spill_dir)) for p in saved)
    assert not os.listdir(spill_dir)


def test_bloom_resume(tmp_path):
    """As tests/test_checkpoint.py:73: a full restore writes the same
    bytes; a partial one recomputes only its missing round; a sort-engine
    run and a JAX Bloom checkpoint on the same directory clear it."""
    rng = np.random.default_rng(80)
    base = oracle.generate_sequence(rng, 1500)
    seqs = _seqs([base, oracle.mutate_sequence(rng, base, 0.03, 0.1)])
    jcfg = JaxConfig(k=9, filter_bits=20, rounds=3, engine="bloom", positions_per_row=128,
                     rows_per_batch=4)
    cfg = config_from_jax(jcfg)
    ck = str(tmp_path / "ck")
    jout = str(tmp_path / "jax.dbg")
    jax_build(None, jcfg, out_path=jout, sequences=seqs, checkpoint_dir=ck)
    want = open(jout, "rb").read()

    def run(name, config=cfg):
        logs = []
        got, _ = _port(tmp_path, config, name, seqs, checkpoint_dir=ck, log=logs.append)
        return got, sum("restored from checkpoint" in line for line in logs)

    assert run("a.dbg") == (want, 0)  # the JAX checkpoint was cleared
    assert {f for f in os.listdir(ck) if f.startswith("round_")} == {
        f"round_{r}.npz" for r in range(3)}
    assert run("b.dbg") == (want, 3)
    os.remove(os.path.join(ck, "round_1.npz"))
    assert run("c.dbg") == (want, 2)
    # the sort engine's meta differs: fresh rounds, the same bytes
    assert run("d.dbg", PipelineConfig(**{**cfg.__dict__, "engine": "sort"})) == (want, 0)
    assert run("e.dbg") == (want, 0)


def _tiny_fasta(tmp_path):
    path = tmp_path / "tiny.fa"
    with open(path, "w") as f:
        for i, s in enumerate(_genomes(9, length=900, n=3)):
            f.write(f">s{i} genome {i}\n{s[:450]}\n{s[450:]}\n")
    return str(path)


@pytest.mark.parametrize("flags", [
    ["-f", "20"],
    ["--filtermemory", "0.001", "--tpu-layout", "block"],
    ["-f", "16", "--tpu-layout", "bit", "-r", "2", "-q", "3",
     "--tpu-positions", "128", "--tpu-rows", "8"],
])
def test_cli_bloom_byte_identical(tmp_path, flags):
    fa = _tiny_fasta(tmp_path)
    tout, jout, sout = (str(tmp_path / n) for n in ("port.dbg", "jax.dbg", "sort.dbg"))
    assert port_main(["-k", "25", "--tpu-engine", "bloom", *flags, "--device", "cpu",
                      fa, "-o", tout]) == 0
    assert jax_main(["-k", "25", "--tpu-engine", "bloom", *flags, fa, "-o", jout]) == 0
    assert port_main(["-k", "25", *flags, "--device", "cpu", fa, "-o", sout]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read() == open(sout, "rb").read()


def test_cli_engine_and_filter_errors(tmp_path, capsys):
    fa = _tiny_fasta(tmp_path)
    out = str(tmp_path / "o.dbg")
    # dist and dist-bloom run (tests/test_torch_distpipe.py), the JAX
    # dist-bloom CLI's bytes
    assert port_main(["-k", "25", "-f", "20", "--tpu-engine", "dist-bloom", "--device", "cpu",
                      fa, "-o", out]) == 0
    assert "bloom-gated sort-join over 1 shards (cpu)" in capsys.readouterr().out
    dist_bloom = open(out, "rb").read()
    jout = out + ".jax"
    assert jax_main(["-k", "25", "-f", "20", "--tpu-engine", "dist-bloom", fa, "-o", jout]) == 0
    assert open(jout, "rb").read() == dist_bloom
    os.remove(out)
    assert port_main(["-k", "25", "-f", "20", "--tpu-engine", "dist", "--device", "cpu",
                      fa, "-o", out]) == 0
    dist = open(out, "rb").read()
    assert dist == dist_bloom
    os.remove(out)
    # dist-bloom on one shard: the one-device layout caps, the JAX message
    assert port_main(["-k", "25", "-f", "36", "--tpu-engine", "dist-bloom", "--device", "cpu",
                      fa, "-o", out]) == 1
    assert "supported layouts (max 2^35 slots" in capsys.readouterr().err
    assert not os.path.exists(out)
    # a filter past its layout's cap exits 1 with the JAX package's message
    assert port_main(["-k", "25", "-f", "31", "--tpu-engine", "bloom", "--tpu-layout",
                      "byte", "--device", "cpu", fa, "-o", out]) == 1
    assert "'byte' Bloom layout supports at most 2^30 slots" in capsys.readouterr().err
    assert not os.path.exists(out)
    # the sort engine allocates no filter: any -f runs (tests/test_review_fixes.py:116)
    assert port_main(["-k", "25", "-f", "40", "--device", "cpu", fa, "-o", out]) == 0
    f40 = open(out, "rb").read()
    assert port_main(["-k", "25", "-f", "20", "--device", "cpu", fa, "-o", out]) == 0
    assert open(out, "rb").read() == f40 == dist


def test_build_junctions_dispatch(tmp_path):
    seqs = _seqs(_genomes(3, length=600, n=2))
    outs = {}
    for engine in ("dist-bloom", "dist", "sort"):
        outs[engine] = str(tmp_path / f"{engine}.dbg")
        enum = build_junctions(None, PipelineConfig(k=9, engine=engine, filter_bits=18,
                                                    positions_per_row=128, rows_per_batch=4),
                               outs[engine], sequences=seqs, device="cpu")
        assert enum.vertices_count > 0
    assert len({open(o, "rb").read() for o in outs.values()}) == 1
    with pytest.raises(ValueError, match="unknown engine"):
        build_junctions(None, PipelineConfig(k=9, engine="hash"), None, sequences=seqs,
                        device="cpu")
    enum = bloompipe.build_junctions_bloom(
        None, PipelineConfig(k=9, filter_bits=16, engine="bloom", positions_per_row=128,
                             rows_per_batch=4), None, sequences=seqs, device="cpu")
    assert enum.vertices_count > 0 and enum.stats.occurrences == 0  # no out_path: no pass 4


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


@pytest.mark.parametrize("k", [11, 25])
@pytest.mark.parametrize("rounds", [1, 3])
def test_bloom_example_goldens(tmp_path, k, rounds):
    """tests/golden/example.fa through the Bloom engine: the reference's
    junction positions and their grouping by id."""
    cfg = PipelineConfig(k=k, rounds=rounds, filter_bits=20, engine="bloom",
                         positions_per_row=256, rows_per_batch=4)
    _b, enum = _port(tmp_path, cfg, "o.dbg", paths=[os.path.join(GOLDEN, "example.fa")])
    assert len(enum.stats.rounds) == rounds
    chrs, pos, ids = junctions.read_junctions(str(tmp_path / "o.dbg"))
    want_c, want_p, want_i = _golden(k)
    np.testing.assert_array_equal(chrs, want_c)
    np.testing.assert_array_equal(pos, want_p)
    assert _groups(chrs, pos, ids) == _groups(want_c, want_p, want_i)
