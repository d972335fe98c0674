"""The port's native host library (twopaco_tpu_torch/native/fastaio.cpp
through io/native.py) against the JAX package's numpy code: the FASTA
encoder against twopaco_tpu.io.fasta._parse_buffer (fuzzed), the record
emit and ChunkWriter against twopaco_tpu.io.junctions.ChunkWriter's numpy
body, and the CLI's .dbg with the native path on and off against the
JAX-confirmed sha256 of tests/golden/torch_port_sha256.json. Exact: every
comparison is of bytes. The library is built with g++ at first use;
tests that need it skip where no C++ compiler is found."""

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from twopaco_tpu.io import fasta as jax_fasta
from twopaco_tpu.io import junctions as jax_junctions
from twopaco_tpu_torch import native as native_build
from twopaco_tpu_torch.cli import twopaco as cli
from twopaco_tpu_torch.io import fasta, junctions, native
from twopaco_tpu_torch.testing import bench_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler found")
    got = native.LIBRARY.get()
    assert got is not None, native.status()
    return got


def _jax_parse(path):
    buf = np.fromfile(path, dtype=np.uint8)
    return list(jax_fasta._parse_buffer(buf, path))


def _outcome(fn, path):
    try:
        return [(h, c.tobytes()) for h, c in fn(path)]
    except RuntimeError:  # FastaError of either package, or the native error
        return "raises"


# ---- the encoder, fuzzed against the JAX package's numpy parser

# header whitespace: every byte that str.split() takes for it in latin-1
_HEADER_CHARS = "abcXYZ019_.|:> \t\r\v\f\x1c\x1f\x85\xa0\xe9"
_BODY_CHARS = "ACGTacgtNnURYKMSWBDHVXurykmswbdhvx \t\r\v\f"
_BAD_CHARS = "Z-1*.@jJ\x00\xff"


@st.composite
def fasta_bytes(draw):
    """FASTA-like bytes: headers with descriptions, '>' in a header line
    and mid-body, every whitespace byte in headers, blank lines,
    lowercase, every ambiguity letter, CRLF, empty records, no final
    newline, and (sometimes) a first byte that is not '>' or an invalid
    character."""
    eol = draw(st.sampled_from(["\n", "\r\n"]))
    parts = []
    if draw(st.integers(0, 9)) == 0:
        parts.append(draw(st.sampled_from(["A", " ", "\n", ";x\n", "ACGT\n"])))
    for _ in range(draw(st.integers(0, 5))):
        header = draw(st.text(_HEADER_CHARS, max_size=12))
        parts.append(">" + header + eol)
        for _ in range(draw(st.integers(0, 4))):
            line = draw(st.text(_BODY_CHARS, max_size=30))
            if draw(st.integers(0, 6)) == 0:  # '>' mid-body starts a record
                cut = draw(st.integers(0, len(line)))
                line = line[:cut] + ">" + line[cut:]
            parts.append(line + eol)
    text = "".join(parts)
    if text and draw(st.integers(0, 9)) == 0:
        at = draw(st.integers(0, len(text) - 1))
        text = text[:at] + draw(st.sampled_from(_BAD_CHARS)) + text[at:]
    if draw(st.booleans()):
        text = text.rstrip("\r\n")
    return text.encode("latin-1")


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=fasta_bytes())
def test_encoder_fuzz_matches_jax_parser(lib, tmp_path, data):
    path = str(tmp_path / "f.fa")
    with open(path, "wb") as f:
        f.write(data)
    assert _outcome(native.encode_fasta_native, path) == _outcome(_jax_parse, path), data


@pytest.mark.parametrize("text", [
    b"", b">", b">\n", b">a b c\nACGT\n>b\n\n>c\nNNNN", b">a\r\nAC\r\nGT\r\n",
    b">x > y\nAC>z w\nGT\n", b">s\nURYKMSWBDHXVurykmswbdhxv\n", b"ACGT\n", b">s\nACGZ\n",
    b">\r0\n", b">\x85a\xa0b\x1cc\n", b">a\vb\fc\nAC\n",  # whitespace as str.split()
])
def test_encoder_cases(lib, tmp_path, text):
    path = str(tmp_path / "f.fa")
    with open(path, "wb") as f:
        f.write(text)
    assert _outcome(native.encode_fasta_native, path) == _outcome(_jax_parse, path)


def test_encoder_across_the_read_chunk(lib, tmp_path):
    """The encoder streams 8 MiB chunks: a header line, a body and a '>'
    that each cross a chunk boundary parse as the numpy parser does."""
    ch = 8 << 20
    rng = np.random.default_rng(5)
    body = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, 3 * ch // 2)]
    text = bytearray(b">first desc\n") + body[: ch - 20].tobytes()
    text += b"\n>straddling header " + b"x" * 40 + b"\n"
    text += body[: 2 * ch - len(text) - 1].tobytes() + b">\n" + body[:1000].tobytes()
    path = str(tmp_path / "big.fa")
    with open(path, "wb") as f:
        f.write(text)
    got, want = _outcome(native.encode_fasta_native, path), _outcome(_jax_parse, path)
    assert [h for h, _ in got] == [h for h, _ in want] == ["first", "straddling", ""]
    assert got == want


def test_read_fasta_errors_raise_fasta_error(lib, tmp_path):
    bad = tmp_path / "bad.fa"
    bad.write_bytes(b">s\nACGZ\n")
    with pytest.raises(fasta.FastaError, match="invalid character 'Z'"):
        list(fasta.read_fasta(bad))
    with pytest.raises(fasta.FastaError, match="Can't open file"):
        list(fasta.read_fasta(tmp_path / "missing.fa"))


def test_read_fasta_takes_native(lib, tmp_path, monkeypatch):
    p = tmp_path / "x.fa"
    p.write_bytes(b">a d\nACGTN\n>b\nry\n")
    calls = []
    orig = native.encode_fasta_native
    monkeypatch.setattr(native, "encode_fasta_native",
                        lambda path: calls.append(path) or orig(path))
    recs = [(h, c.tolist()) for h, c in fasta.read_fasta(p)]
    assert calls and recs == [("a", [0, 1, 2, 3, 4]), ("b", [4, 4])]


# ---- the record emit against the JAX package's ChunkWriter

def _chunks(seed):
    """(chrs, pos, ids) chunks in stream order: skipped chromosomes, a
    chromosome change on a chunk boundary, one-record chunks, an empty
    chunk, and a first chunk that starts past chromosome 0."""
    rng = np.random.default_rng(seed)
    out, chr_now = [], int(rng.integers(0, 3))
    for size in (5, 0, 1, 1, 40, 3, 1, 200, 7):
        steps = rng.integers(0, 2, size) * rng.integers(1, 4, size)
        chrs = chr_now + np.cumsum(steps)
        if size and rng.random() < 0.4:  # change exactly at the boundary
            chrs = chrs + 1
        pos = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.int64)
        ids = rng.integers(-(1 << 62), 1 << 62, size)
        out.append((chrs.astype(np.int64), pos, ids))
        chr_now = int(chrs[-1]) if size else chr_now
    return out


def _write_all(writer_cls, path, chunks):
    with writer_cls(path) as w:
        for c in chunks:
            w.write(*c)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_writer_matches_jax(lib, tmp_path, monkeypatch, seed):
    chunks = _chunks(seed)
    # the JAX writer's numpy body, without its native loader
    monkeypatch.setattr(jax_junctions._native, "emit_records", lambda *a, **kw: None)
    want = _write_all(jax_junctions.ChunkWriter, str(tmp_path / "jax.dbg"), chunks)
    got = _write_all(junctions.ChunkWriter, str(tmp_path / "port.dbg"), chunks)
    assert got == want and len(got) % 12 == 0
    monkeypatch.setenv("TWOPACO_NATIVE", "0")
    assert _write_all(junctions.ChunkWriter, str(tmp_path / "np.dbg"), chunks) == want


def test_emit_records_one_pass(lib):
    chunks = [c for c in _chunks(3) if len(c[0])]
    now, parts, scratch = 0, [], None
    for chrs, pos, ids in chunks:
        buf = native.emit_records(chrs, pos.astype(np.uint32), ids, now, scratch)
        scratch = buf.base if buf.base is not None else buf
        parts.append(buf.tobytes())
        now = int(chrs[-1])
    rec = np.frombuffer(b"".join(parts), dtype=junctions.RECORD_DTYPE)
    sep = (rec["pos"] == junctions.SEPARATOR_POS) & (rec["id"] == junctions.SEPARATOR_ID)
    assert int(sep.sum()) == now
    np.testing.assert_array_equal(rec["id"][~sep], np.concatenate([c[2] for c in chunks]))
    with pytest.raises(ValueError):
        native.emit_records(chunks[0][0], chunks[0][1], chunks[0][2], 0)  # int64 pos


def test_native_off_takes_numpy(lib, tmp_path, monkeypatch):
    """TWOPACO_NATIVE=0 with the loader cache reset: the numpy path, the
    same codes and bytes."""
    fa = bench_data.write_bench_fasta(str(tmp_path / "b.fa"), 2, 3000, 4)
    want = [(h, c.tobytes()) for h, c in fasta.read_fasta(fa)]
    monkeypatch.setattr(native, "LIBRARY", native.NativeLibrary())
    monkeypatch.setenv("TWOPACO_NATIVE", "0")
    assert not native.available() and "TWOPACO_NATIVE=0" in native.status()
    monkeypatch.setattr(native, "encode_fasta_native", None)  # never called
    assert [(h, c.tobytes()) for h, c in fasta.read_fasta(fa)] == want


def test_no_compiler_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    lib = native.NativeLibrary(build_dir=tmp_path / "build")
    monkeypatch.setattr(native, "LIBRARY", lib)
    assert not native.available()
    assert "no compiler found" in native.status()
    assert not (tmp_path / "build").exists()
    p = tmp_path / "x.fa"
    p.write_bytes(b">a\nACGT\n")
    assert [(h, c.tolist()) for h, c in fasta.read_fasta(p)] == [("a", [0, 1, 2, 3])]


# ---- the CLI, native on and off, against the JAX-confirmed sha256

def _golden_input(spec, tmp_path):
    paths = []
    for i, src in enumerate(spec["input"] if isinstance(spec["input"], list)
                            else [spec["input"]]):
        if src.startswith("bench:"):
            n, length, seed = (int(x) for x in src[6:].split(":"))
            src = bench_data.write_bench_fasta(str(tmp_path / f"in{i}.fa"), n, length, seed)
        else:
            src = os.path.join(ROOT, src)
        paths.append(src)
    return paths


@pytest.mark.parametrize("name", ["example_k11", "bench_two_files_k25"])
@pytest.mark.parametrize("native_on", ["1", "0"])
def test_cli_golden_sha256(lib, tmp_path, monkeypatch, capsys, name, native_on):
    with open(os.path.join(GOLDEN, "torch_port_sha256.json")) as f:
        spec = json.load(f)[name]
    monkeypatch.setenv("TWOPACO_NATIVE", native_on)
    out = str(tmp_path / "o.dbg")
    argv = ["--device", "cpu", "-k", str(spec["k"]), "-f", "20",
            *_golden_input(spec, tmp_path), "-o", out]
    assert cli.main(argv) == 0, capsys.readouterr().err
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == spec["sha256"]


# ---- where it builds

def test_builds_under_the_port(lib):
    path = native.LIBRARY.path
    assert path.parent == native_build.BUILD_DIR
    assert str(path).startswith(os.path.join(ROOT, "twopaco_tpu_torch", "native", "build"))
    assert (path.parent / (path.stem + ".log")).exists()


def test_concurrent_builds(lib, tmp_path):
    """Loaders racing to build into one directory each load a whole
    library and leave one file; nothing is written under the JAX
    package's native/."""
    jax_native = os.path.join(ROOT, "native")
    before = sorted(os.listdir(jax_native))
    libs = [native.NativeLibrary(build_dir=tmp_path) for _ in range(4)]
    threads = [threading.Thread(target=x.get) for x in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(x.status().startswith("loaded") for x in libs), [x.status() for x in libs]
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]
    assert sorted(os.listdir(jax_native)) == before


def test_retain_heap_switch(monkeypatch):
    import ctypes

    import twopaco_tpu_torch

    def boom(*a, **kw):
        raise AssertionError("mallopt called with TWOPACO_RETAIN_HEAP=0")

    monkeypatch.setenv("TWOPACO_RETAIN_HEAP", "0")
    monkeypatch.setattr(ctypes, "CDLL", boom)
    twopaco_tpu_torch._retain_heap()
