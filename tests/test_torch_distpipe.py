"""The port's distributed engine end to end on the CPU (the plain versions,
a LocalMesh of 8 CPU shards) against twopaco_tpu's build_junctions_dist
(the conftest's 8 virtual CPU devices) and the port's sort engine: the
.dbg must be byte-identical in every case of tests/test_distpipe.py, the
Bloom gate (dist-bloom) included, through a checkpoint resume, the
measurement passes and the CLI."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twopaco_tpu import dna as jdna
from twopaco_tpu.cli.twopaco import main as jax_main
from twopaco_tpu.io import windows as jwindows
from twopaco_tpu.parallel import distpipe as jdist
from twopaco_tpu.parallel.sharded import make_mesh
from twopaco_tpu.passes import PipelineConfig as JaxConfig
from twopaco_tpu.passes import kernels as jkernels
from twopaco_tpu.testing import oracle
from twopaco_tpu_torch.cli.twopaco import main as port_main
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.parallel import distpipe, sharded
from twopaco_tpu_torch.parallel.mesh import LocalMesh
from twopaco_tpu_torch.passes import histogram, sortpipe
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, build_junctions, config_from_jax

D = 8


def _corpus(seed=7, n=3, length=2000, snp=0.05, ins=0.1):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [(0, jdna.encode(base))] + [
        (i, jdna.encode(oracle.mutate_sequence(rng, base, snp, ins))) for i in range(1, n)
    ]


def _at_rich(seed=5, n=4, length=4000):
    """~90% A/T: word0 crowds a narrow range (tests/test_distpipe.py:78)."""
    rng = np.random.default_rng(seed)
    at = np.array([0, 3], np.uint8)
    return [
        (i, np.where(rng.random(length) < 0.9, at[rng.integers(0, 2, size=length)],
                     rng.integers(0, 4, size=length).astype(np.uint8)).astype(np.uint8))
        for i in range(n)
    ]


def _three_ways(tmp_path, jcfg, seqs, bloom_gate=False, **kw):
    """-> (JAX dist bytes, port dist bytes, port sort bytes, port dist enum)."""
    jout, dout, sout = (str(tmp_path / n) for n in ("jax.dbg", "dist.dbg", "sort.dbg"))
    jdist.build_junctions_dist(None, jcfg, mesh=make_mesh(D), out_path=jout, sequences=seqs,
                               bloom_gate=bloom_gate)
    cfg = config_from_jax(jcfg)
    enum = distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * D), dout,
                                         sequences=seqs, device="cpu", bloom_gate=bloom_gate,
                                         **kw)
    sortpipe.build_junctions_sorted(None, cfg, sout, sequences=seqs, device="cpu")
    return tuple(open(p, "rb").read() for p in (jout, dout, sout)) + (enum,)


@pytest.mark.parametrize("rounds", [1, 3])
def test_dist_engine_byte_identical(tmp_path, rounds):
    jcfg = JaxConfig(k=9, rounds=rounds, positions_per_row=128, rows_per_batch=8)
    lines = []
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _corpus(), log=lines.append)
    assert jb == db == sb and len(db) > 0
    assert enum.vertices_count > 0 and enum.stats.occurrences > 0
    assert len(enum.stats.rounds) == rounds
    assert any(f"over {D} shards" in s for s in lines)


def test_dist_engine_multi_shard_counts(tmp_path, monkeypatch):
    """k=11: junctions spread over several shards (not all on one)."""
    got = {}
    orig = sortpipe.merge_fetched

    def capture(fetched, *a, **kw):
        got.setdefault("fetched", fetched)  # the dist run's (the first)
        return orig(fetched, *a, **kw)

    monkeypatch.setattr(sortpipe, "merge_fetched", capture)
    jcfg = JaxConfig(k=11, positions_per_row=128, rows_per_batch=8)
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _corpus(seed=11, n=4, length=3000))
    assert jb == db == sb and enum.vertices_count > 50
    tables = [len(e[0]) for e in got["fetched"]]
    assert len(tables) == D and sum(t > 0 for t in tables) >= D // 2
    assert all(isinstance(e[1], distpipe.sortpipe.OccKeys) for e in got["fetched"])


def test_quantile_bounds_route_skewed_input(tmp_path):
    """The AT-rich corpus routes without overflow at round_slack 1.25 by
    measured bounds."""
    jcfg = JaxConfig(k=9, positions_per_row=128, rows_per_batch=8, round_slack=1.25)
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _at_rich())
    assert jb == db == sb and enum.vertices_count > 0


@pytest.mark.parametrize("rounds", [1, 3])
def test_dist_engine_wide_positions(tmp_path, monkeypatch, rounds):
    """TWOPACO_POS64=1: the wide merge layout (33 position bits, 31-bit
    ids in the sorted keys), the same bytes."""
    monkeypatch.setenv("TWOPACO_POS64", "1")
    jcfg = JaxConfig(k=9, rounds=rounds, positions_per_row=128, rows_per_batch=8)
    jb, db, sb, _enum = _three_ways(tmp_path, jcfg, _corpus(seed=21))
    assert jb == db == sb


def test_dist_engine_checkpoint_resume(tmp_path):
    """A resumed run (round 1 recomputed, rounds 0 and 2 restored) writes
    the uncheckpointed run's bytes; the JAX engine's too."""
    jcfg = JaxConfig(k=9, rounds=3, positions_per_row=128, rows_per_batch=8)
    seqs = _corpus(seed=13)
    jout = str(tmp_path / "jax.dbg")
    jdist.build_junctions_dist(None, jcfg, mesh=make_mesh(D), out_path=jout, sequences=seqs)
    cfg = config_from_jax(jcfg)
    ck = str(tmp_path / "ckpt")

    def run(name, **kw):
        out = str(tmp_path / name)
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * D), out, sequences=seqs,
                                      device="cpu", **kw)
        return open(out, "rb").read()

    plain = run("plain.dbg")
    first = run("first.dbg", checkpoint_dir=ck)
    assert sorted(f for f in os.listdir(ck) if f.startswith("round_")) == [
        f"round_{r}.npz" for r in range(3)]
    os.remove(os.path.join(ck, "round_1.npz"))
    lines = []
    resumed = run("resumed.dbg", checkpoint_dir=ck, log=lines.append)
    assert sum("restored from checkpoint" in s for s in lines) == 2
    assert plain == first == resumed == open(jout, "rb").read()


@pytest.mark.parametrize("rounds,layout", [(1, "byte"), (2, "byte"), (1, "bit"), (2, "bit")])
def test_dist_bloom_byte_identical(tmp_path, rounds, layout):
    """dist-bloom (tests/test_distpipe.py:176): the filter sharded over 8
    shards, only candidates routed; the JAX engine's and the sort engine's
    bytes, and the JAX run's candidate marks."""
    jcfg = JaxConfig(k=9, rounds=rounds, filter_bits=18, hash_functions=2, layout=layout,
                     positions_per_row=128, rows_per_batch=8)
    lines = []
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _corpus(seed=31), bloom_gate=True,
                                   log=lines.append)
    assert jb == db == sb and len(db) > 0
    assert len(enum.stats.rounds) == rounds
    assert any(f"bloom-gated sort-join over {D} shards" in s for s in lines)
    assert any(f"({layout} layout, 32768 slots a shard)" in s for s in lines)
    marks = sum(r["marks"] for r in enum.stats.rounds)
    assert enum.stats.occurrences - enum.stats.stub_ids <= marks < enum.stats.total_positions
    for key in ("fill", "mark"):
        assert enum.stats.timings[key] > 0


@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("bloom_gate", [False, True])
def test_dist_engines_cut_key_bits(tmp_path, k, bloom_gate):
    """k = 25 (w = 2: the u64 key cut to its 50 k-mer bits) and k = 33
    (w = 3: the last word cut to 2 bits), dist and dist-bloom at -r 2: the
    JAX engine's bytes and the sort engine's."""
    gate = dict(filter_bits=18, hash_functions=2) if bloom_gate else {}
    jcfg = JaxConfig(k=k, rounds=2, positions_per_row=128, rows_per_batch=8, **gate)
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _corpus(seed=k), bloom_gate=bloom_gate)
    assert jb == db == sb and len(db) > 0 and enum.vertices_count > 0


def test_dist_bloom_many_hash_functions(tmp_path):
    """q = 64 (512 mark probes a position, the bucketing kernel's tile cut
    to 8 positions at f >= 32): the JAX engine's bytes and the sort
    engine's."""
    jcfg = JaxConfig(k=9, filter_bits=18, hash_functions=64, positions_per_row=128,
                     rows_per_batch=8)
    jb, db, sb, enum = _three_ways(tmp_path, jcfg, _corpus(seed=64, length=1200),
                                   bloom_gate=True)
    assert jb == db == sb and len(db) > 0 and enum.vertices_count > 0


def test_dist_bloom_three_shards(tmp_path):
    """D=3 (local slots padded to 32, owners by index mod 3): the sort
    engine's bytes, -r 1 and -r 2."""
    seqs = _corpus(seed=17)
    for rounds in (1, 2):
        cfg = PipelineConfig(k=11, rounds=rounds, filter_bits=17, hash_functions=3,
                             positions_per_row=128, rows_per_batch=6)
        out, sout = str(tmp_path / "db.dbg"), str(tmp_path / "s.dbg")
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 3), out, sequences=seqs,
                                      device="cpu", bloom_gate=True)
        sortpipe.build_junctions_sorted(None, cfg, sout, sequences=seqs, device="cpu")
        assert open(out, "rb").read() == open(sout, "rb").read()


def test_dist_bloom_checkpoint_resume(tmp_path):
    """A resumed dist-bloom run (round 1 recomputed) writes the bytes of
    the uncheckpointed run."""
    cfg = PipelineConfig(k=9, rounds=3, filter_bits=18, hash_functions=2,
                         positions_per_row=128, rows_per_batch=8)
    seqs = _corpus(seed=13)
    ck = str(tmp_path / "ckpt")

    def run(name, **kw):
        out = str(tmp_path / name)
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 4), out, sequences=seqs,
                                      device="cpu", bloom_gate=True, **kw)
        return open(out, "rb").read()

    plain = run("plain.dbg")
    first = run("first.dbg", checkpoint_dir=ck)
    os.remove(os.path.join(ck, "round_1.npz"))
    lines = []
    resumed = run("resumed.dbg", checkpoint_dir=ck, log=lines.append)
    assert sum("restored from checkpoint" in s for s in lines) == 2
    assert plain == first == resumed


def test_dist_bloom_route_overflows_raise(tmp_path, monkeypatch):
    """A fill that cannot be sent is a false negative: it raises before any
    mark. A mark probe that cannot be sent raises as a route drop."""
    cfg = PipelineConfig(k=9, filter_bits=18, hash_functions=2, positions_per_row=128,
                         rows_per_batch=8)
    out = str(tmp_path / "o.dbg")
    lines = []
    monkeypatch.setattr(sharded.ShardedConfig, "fill_cap", property(lambda self: 16))
    with pytest.raises(RuntimeError, match=r"sharded Bloom fill route overflow \(\d+\)"):
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 4), out,
                                      sequences=_corpus(), device="cpu", bloom_gate=True,
                                      log=lines.append)
    assert not any("seconds" in s for s in lines) and not os.path.exists(out)
    monkeypatch.undo()
    monkeypatch.setattr(sharded.ShardedConfig, "mark_cap", property(lambda self: 16))
    with pytest.raises(RuntimeError, match="distributed record buffer overflow"):
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 4), out,
                                      sequences=_corpus(), device="cpu", bloom_gate=True)


def test_dist_bloom_refusals():
    seqs = _corpus()
    with pytest.raises(ValueError, match="single-chip only; use --tpu-layout bit"):
        distpipe.build_junctions_dist(
            None, PipelineConfig(k=9, filter_bits=18, layout="block", positions_per_row=128,
                                 rows_per_batch=8),
            LocalMesh(["cpu"] * 4), None, sequences=seqs, device="cpu", bloom_gate=True)
    # one shard: -f 36 passes the bit layout's cap, as the Bloom engine's
    with pytest.raises(ValueError, match="per device"):
        distpipe.build_junctions_dist(
            None, PipelineConfig(k=9, filter_bits=36, positions_per_row=128, rows_per_batch=8),
            LocalMesh(["cpu"]), None, sequences=seqs, device="cpu", bloom_gate=True)


def test_word0_histogram_matches_jax():
    k, P, B = 25, 256, 8
    rng = np.random.default_rng(4)
    base = oracle.generate_sequence(rng, 3000)
    seqs = [(0, jdna.encode(base)), (1, jdna.encode(oracle.mutate_sequence(rng, base, 0.05, 0.1)))]
    wcfg = jwindows.WindowConfig(k=k, positions_per_row=P, rows_per_batch=B)
    b = next(jwindows.iter_window_batches(iter(seqs), wcfg))
    want = np.asarray(jdist.word0_histogram(
        jnp.asarray(b.codes), jnp.asarray(b.valid),
        cfg=jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)))
    p, m = pack.pack_codes_host(b.codes)
    args = [torch.from_numpy(a) for a in (p, m, b.valid)]
    got = histogram.word0_histogram_plain(*args, k=k, P=P)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    acc = torch.zeros(1 << 16, dtype=torch.int32)
    histogram.word0_histogram(*args, k=k, P=P, out=acc)
    histogram.word0_histogram(*args, k=k, P=P, out=acc)
    np.testing.assert_array_equal(acc.numpy(), 2 * want)


def test_word0_histogram_batches_matches_jax():
    """The batched entry (one launch a shard on the card; here its plain
    version, the per-batch function over the batches) equals the sum of
    JAX's per-batch word0_histogram: five batches, different valid counts,
    one with no valid position."""
    k, P, B = 25, 256, 8
    rng = np.random.default_rng(9)
    base = oracle.generate_sequence(rng, 6000)
    seqs = [(0, jdna.encode(base)), (1, jdna.encode(oracle.mutate_sequence(rng, base, 0.05, 0.1)))]
    wcfg = jwindows.WindowConfig(k=k, positions_per_row=P, rows_per_batch=B)
    jcfg = jkernels.PassConfig(k=k, positions_per_row=P, rows_per_batch=B)
    batches = list(jwindows.iter_window_batches(iter(seqs), wcfg))[:5]
    assert len(batches) == 5
    want = np.zeros(1 << 16, np.int64)
    uploads = []
    for i, b in enumerate(batches):
        valid = np.minimum(b.valid, rng.integers(0, P + 1, size=B)).astype(np.int32)
        if i == 2:
            valid[:] = 0
        want += np.asarray(jdist.word0_histogram(jnp.asarray(b.codes), jnp.asarray(valid),
                                                 cfg=jcfg))
        p, m = pack.pack_codes_host(b.codes)
        uploads.append([torch.from_numpy(a) for a in (p, m, valid)])
    for fn in (histogram.word0_histogram_batches, histogram.word0_histogram_batches_plain):
        got = fn(uploads, k=k, P=P)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    acc = torch.ones(1 << 16, dtype=torch.int32)
    histogram.word0_histogram_batches(uploads, k=k, P=P, out=acc)
    np.testing.assert_array_equal(acc.numpy(), want + 1)
    assert want.sum() > 0


@pytest.mark.parametrize("case", ["random", "concentrated", "one_bin", "empty", "top_bin"])
@pytest.mark.parametrize("n_dev", [1, 2, 8, 13])
def test_route_bounds_match_jax(case, n_dev):
    rng = np.random.default_rng(n_dev)
    hist = np.zeros(1 << 16, np.int64)
    if case == "random":
        hist[:] = rng.integers(0, 1000, size=1 << 16)
    elif case == "concentrated":
        hist[: 1 << 12] = 1000  # strong GC bias (tests/test_distpipe.py:251)
    elif case == "one_bin":
        hist[12345] = 10**6
    elif case == "top_bin":
        hist[-1] = 7
    got = distpipe.route_bounds_from_hist(hist, n_dev)
    want = jdist.route_bounds_from_hist(hist, n_dev, 16)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32 and len(got) == n_dev - 1
    assert (np.diff(got.astype(np.int64)) > 0).all()


def _fasta(tmp_path):
    path = tmp_path / "g.fa"
    with open(path, "w") as f:
        for i, (_sid, codes) in enumerate(_corpus(seed=9, n=3, length=1200)):
            s = jdna.decode(codes)
            f.write(f">s{i} genome {i}\n{s[:600]}\n{s[600:]}\n")
    return str(path)


def test_cli_dist_engine(tmp_path, capsys):
    """--tpu-engine dist --device cpu: the sort engine's and the JAX dist
    engine's bytes, -r 2 included, with the route phase timed."""
    fa = _fasta(tmp_path)
    for flags in ([], ["-r", "2"]):
        tout, sout, jout = (str(tmp_path / n) for n in ("port.dbg", "sort.dbg", "jax.dbg"))
        assert port_main(["-k", "25", "-f", "20", "--tpu-engine", "dist", *flags, "--device",
                          "cpu", fa, "-o", tout]) == 0
        text = capsys.readouterr().out
        assert port_main(["-k", "25", "-f", "20", *flags, "--device", "cpu", fa, "-o", sout]) == 0
        assert jax_main(["-k", "25", "-f", "20", "--tpu-engine", "dist", *flags, fa,
                         "-o", jout]) == 0
        capsys.readouterr()
        assert open(tout, "rb").read() == open(sout, "rb").read() == open(jout, "rb").read()
        assert "over 1 shards (cpu)" in text
        keys = {line.split("\t")[1] for line in text.splitlines() if line.startswith("time\t")}
        assert set(distpipe.PHASES) <= keys


def test_dist_rows_not_multiple_of_mesh(tmp_path):
    cfg = PipelineConfig(k=9, positions_per_row=128, rows_per_batch=6)
    with pytest.raises(ValueError, match=r"rows_per_batch \(6\) must be a multiple of the "
                                         r"mesh size \(4\)"):
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 4), None,
                                      sequences=_corpus(), device="cpu")


def test_dist_overflow_raises():
    """A round buffer too small for its records raises, naming the knob."""
    cfg = PipelineConfig(k=9, positions_per_row=128, rows_per_batch=8, round_slack=0.05)
    with pytest.raises(RuntimeError, match="distributed record buffer overflow"):
        distpipe.build_junctions_dist(None, cfg, LocalMesh(["cpu"] * 4), None,
                                      sequences=_corpus(), device="cpu")


def test_dist_engine_dispatch_and_stats(tmp_path):
    """build_junctions(engine="dist") runs the dist engine on one CPU shard
    with the round statistics of the sort engine's runs."""
    cfg = PipelineConfig(k=9, rounds=2, positions_per_row=128, rows_per_batch=8, engine="dist")
    out = str(tmp_path / "d.dbg")
    enum = build_junctions(None, cfg, out, sequences=_corpus(seed=3), device="cpu")
    sout = str(tmp_path / "s.dbg")
    sortpipe.build_junctions_sorted(None, cfg, sout, sequences=_corpus(seed=3), device="cpu")
    assert open(out, "rb").read() == open(sout, "rb").read()
    assert len(enum.stats.rounds) == 2
    assert sum(r["true_junctions"] for r in enum.stats.rounds) == enum.vertices_count
    for key in ("build", "route", "sort", "judge", "fetch"):
        assert enum.stats.rounds[0][f"t_{key}"] >= 0
