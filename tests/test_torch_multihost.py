"""The port's multi-process entry (parallel/multihost.py) across real
processes: 4 gloo processes on the CPU, one shard each, rendezvous on
localhost through torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), as tests/test_multihost.py does with jax.distributed. Rank
0 must write the single-device sort engine's bytes, narrow and wide, with
and without the Bloom gate (dist-bloom: the sharded filter's exchanges
cross the processes), and a checkpointed run must resume across a fresh
set of processes.

Run as a script, this file is the worker: it reads its parameters from
TWOPACO_MH_SPEC (JSON) and prints one MH_RESULT line.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(k=9, rounds=2, positions_per_row=128, rows_per_batch=8)
N_PROC = 4


def _corpus(seed=11, n=3, length=1500):
    from twopaco_tpu_torch.testing import oracle

    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    return [base] + [oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(1, n)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(spec: dict, n_proc: int = N_PROC, timeout: float = 120.0, rendezvous=True):
    """n_proc workers; -> {rank: MH_RESULT dict}."""
    port = _free_port()
    procs = []
    for rank in range(n_proc):
        env = dict(os.environ, TWOPACO_MH_SPEC=json.dumps(spec), OMP_NUM_THREADS="1")
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(var, None)
        if rendezvous:
            env.update(RANK=str(rank), WORLD_SIZE=str(n_proc), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    results = {}
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
            line = [s for s in out.splitlines() if s.startswith("MH_RESULT ")]
            assert line, f"worker {rank} printed no result:\n{out[-4000:]}"
            results[rank] = json.loads(line[-1][len("MH_RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    """The FASTA and the single-device sort engine's .dbg of it."""
    from twopaco_tpu_torch.passes.pipeline import PipelineConfig
    from twopaco_tpu_torch.passes.sortpipe import build_junctions_sorted

    tmp = tmp_path_factory.mktemp("mh")
    fa = str(tmp / "in.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(_corpus()):
            f.write(f">chr{i}\n{s}\n")
    golden = str(tmp / "golden.dbg")
    enum = build_junctions_sorted([fa], PipelineConfig(**CONFIG), golden, device="cpu")
    return fa, open(golden, "rb").read(), enum.vertices_count, tmp


@pytest.mark.parametrize("wide", [False, True])
def test_four_process_byte_identical(fixture_paths, wide):
    """Narrow, and the wide merge layout (force_wide): rank 0 writes the
    sort engine's bytes; every rank returns the same dictionary."""
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / f"mh{int(wide)}.dbg")
    results = _launch({"fa": fa, "out": out, "config": dict(CONFIG, force_wide=wide)})
    for rank, r in results.items():
        assert (r["rank"], r["shards"], r["vertices"]) == (rank, N_PROC, n_vert)
    assert open(out, "rb").read() == golden


def test_four_process_bloom_gate_byte_identical(fixture_paths):
    """dist-bloom across 4 real processes (tests/test_multihost.py:132):
    the fill and mark all_to_alls of the hash-sharded filter cross gloo,
    and rank 0 writes the sort engine's bytes."""
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / "mh_bloom.dbg")
    results = _launch({"fa": fa, "out": out, "bloom_gate": True,
                       "config": dict(CONFIG, filter_bits=18, hash_functions=3)})
    for rank, r in results.items():
        assert (r["rank"], r["shards"], r["vertices"]) == (rank, N_PROC, n_vert)
    assert results[0]["marks"] > 0
    assert open(out, "rb").read() == golden


def test_four_process_checkpoint_resume(fixture_paths):
    """Rank 0 writes the round files; a fresh set of processes resumes
    (round 1 recomputed, round 0 restored) and writes the same bytes."""
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / "mh_ck.dbg")
    ckdir = str(tmp / "ck")
    spec = {"fa": fa, "out": out, "config": CONFIG, "checkpoint_dir": ckdir}
    first = _launch(spec)
    assert sorted(f for f in os.listdir(ckdir) if f.startswith("round_")) == [
        "round_0.npz", "round_1.npz"]
    assert open(out, "rb").read() == golden
    assert first[0]["restored"] == 0
    os.unlink(out)
    os.remove(os.path.join(ckdir, "round_1.npz"))
    second = _launch(spec)
    assert open(out, "rb").read() == golden
    assert second[0]["restored"] == 1  # rank 0 logs
    assert all(r["vertices"] == n_vert for r in second.values())


def test_one_process_without_launcher(fixture_paths):
    """No launcher variables: a one-rank gloo group on a free localhost
    port, through the same exchange."""
    fa, golden, _n_vert, tmp = fixture_paths
    out = str(tmp / "mh1.dbg")
    (r,) = _launch({"fa": fa, "out": out, "config": CONFIG}, n_proc=1,
                   rendezvous=False).values()
    assert (r["rank"], r["shards"]) == (0, 1)
    assert open(out, "rb").read() == golden


def _worker() -> None:
    spec = json.loads(os.environ["TWOPACO_MH_SPEC"])
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from twopaco_tpu_torch.parallel.multihost import build_junctions_multihost
    from twopaco_tpu_torch.passes.pipeline import PipelineConfig

    lines = []
    enum = build_junctions_multihost(
        [spec["fa"]], PipelineConfig(**spec["config"]), out_path=spec["out"],
        log=lines.append, checkpoint_dir=spec.get("checkpoint_dir"), device="cpu",
        bloom_gate=spec.get("bloom_gate", False),
    )
    print("MH_RESULT " + json.dumps({
        "rank": dist.get_rank(),
        "shards": dist.get_world_size(),
        "vertices": enum.vertices_count,
        "restored": sum("restored from checkpoint" in s for s in lines),
        "marks": sum(r["marks"] for r in enum.stats.rounds),
    }), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker()
