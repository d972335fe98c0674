"""The port's front end against the JAX package's on the CPU: io/windows.py
window_rows (the rows' metadata and their table into the staged codes)
plus passes/upload.py's plain pack (the CPU counterpart of
kernels/csrc/upload.cu), through sortpipe.read_batches and upload_batches,
against twopaco_tpu.io.windows.iter_window_batches plus
twopaco_tpu.ops.pack.pack_codes_host, on the same sequences made from a
seed with numpy. Tolerance: exact (every packed word, mask word, valid
count and metadata field equal)."""

import os

import numpy as np
import pytest
import torch

from twopaco_tpu.io import fasta as jfasta
from twopaco_tpu.io import windows as jwindows
from twopaco_tpu.ops import pack as jpack
from twopaco_tpu_torch import hostmem
from twopaco_tpu_torch.io import fasta, windows
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import sortpipe, upload
from twopaco_tpu_torch.passes.pipeline import PipelineConfig, RunStats

CPU = torch.device("cpu")
META = ("seq_id", "pos0", "valid", "n_pos")


def _sequences(seed, k, P, n=9):
    """Sequences of every awkward length (empty, shorter than k, k, a row's
    positions exactly, one more, several rows), N runs across each row's
    first and last chars and at both ends, and random N runs."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, k - 1, k, k + P - 1, k + P, k + 2 * P - 1, 3 * P + k + 5]
    lengths += [int(x) for x in rng.integers(k, 4 * P + k, size=n)]
    seqs = []
    for i, L in enumerate(lengths):
        c = rng.integers(0, 4, size=L).astype(np.uint8)
        for edge in range(0, L, P):  # a row's S'[a-1] is code a-2
            c[max(edge - 2, 0) : edge + 1] = 4
            c[min(edge + k - 1, L) : edge + k + 2] = 4
        c[rng.random(L) < 0.01] = 4
        if L > 3:
            c[:2] = 4 if i % 2 else c[:2]
            c[-2:] = 4 if i % 3 else c[-2:]
        seqs.append((i, c))
    return seqs


def _port(seqs, k, P, B, rows=slice(None), stage_bytes=None):
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    _seqs, batches = sortpipe.read_batches(None, seqs, cfg, RunStats())
    return batches, sortpipe.upload_batches(batches, CPU, rows=rows,
                                            stage_bytes=stage_bytes)


def _assert_matches_jax(seqs, k, P, B, batches, uploads, rows=slice(None)):
    want = list(jwindows.iter_window_batches(iter(seqs), jwindows.WindowConfig(k, P, B)))
    assert len(batches) == len(uploads) == len(want)
    for b, (p, m, v), jb in zip(batches, uploads, want):
        assert b.codes is None and b.row0 == jb.row0
        for f in META:
            got, exp = getattr(b, f), getattr(jb, f)
            assert got.dtype == exp.dtype and np.array_equal(got, exp), f
        jp, jm = jpack.pack_codes_host(jb.codes[rows])
        assert p.dtype == m.dtype == torch.uint32 and v.dtype == torch.int32
        np.testing.assert_array_equal(pack.as_i64(p).numpy(), jp.astype(np.int64))
        np.testing.assert_array_equal(pack.as_i64(m).numpy(), jm.astype(np.int64))
        np.testing.assert_array_equal(v.numpy(), jb.valid[rows])


@pytest.mark.parametrize("k", [5, 25, 33, 63, 101])
@pytest.mark.parametrize("P,B", [(16, 3), (64, 4)])
def test_upload_matches_jax(k, P, B):
    """Exact: the batches' metadata, packed words, N masks and valid counts
    of the JAX package's host windows and pack."""
    seqs = _sequences(k * 7 + P, k, P)
    batches, uploads = _port(seqs, k, P, B)
    _assert_matches_jax(seqs, k, P, B, batches, uploads)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("k", [5, 25])
def test_upload_shard_rows_match_jax(k, D):
    """Exact: a dist shard's rows (rows s*B/D .. of every batch)."""
    P, B = 32, 8
    seqs = _sequences(D + k, k, P)
    for s in range(D):
        rows = slice(s * B // D, (s + 1) * B // D)
        batches, uploads = _port(seqs, k, P, B, rows)
        _assert_matches_jax(seqs, k, P, B, batches, uploads, rows)


@pytest.mark.parametrize("stage_bytes", [1, 400, 2000])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_upload_in_chunks_matches_jax(D, stage_bytes):
    """Exact: the upload packed in chunks of consecutive batches (a
    staging budget of one batch a chunk, or a few), a whole run's rows and
    a dist shard's, against the JAX package's host windows and pack."""
    k, P, B = 25, 16, 4
    seqs = _sequences(D * 31 + stage_bytes, k, P, n=12)
    for s in range(D):
        rows = slice(s * B // D, (s + 1) * B // D)
        batches, uploads = _port(seqs, k, P, B, rows, stage_bytes)
        r = len(range(B)[rows])
        chunks, least = upload.plan_chunks(batches.table[_rows_of(batches, rows)],
                                           batches.row_chars, r, batches.codes.numel(),
                                           stage_bytes)
        assert len(chunks) > (1 if stage_bytes < 2000 else 0)
        _assert_matches_jax(seqs, k, P, B, batches, uploads, rows)


def _rows_of(batches, rows):
    B = len(batches[0].seq_id)
    return (np.arange(len(batches))[:, None] * B + np.arange(B)[rows]).reshape(-1)


@pytest.mark.parametrize("budget", [None, 1, 300, 1000, 5000])
def test_plan_chunks_cover_every_row(budget):
    """Exact: the chunks cut the batches in order, each within the budget
    unless it is one batch, and each chunk's span holds every code its rows
    read, on 16-byte bounds."""
    k, P, B = 11, 16, 4
    seqs = _sequences(7, k, P, n=10)
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    _seqs, batches = sortpipe.read_batches(None, seqs, cfg, RunStats())
    R, n = batches.row_chars, batches.codes.numel()
    chunks, least = upload.plan_chunks(batches.table, R, B, n, budget)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(batches)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for b0, b1, lo, hi in chunks:
        assert lo % 16 == 0 and hi % 16 == 0 and 0 <= lo <= hi <= n
        assert budget is None or b1 - b0 == 1 or hi - lo + 24 * B * (b1 - b0) <= budget
        assert hi - lo + 24 * B <= least or b1 - b0 > 1
        for off, slo, shi in batches.table[b0 * B : b1 * B]:
            a, e = max(off, slo), min(off + R, shi)
            assert a >= e or (lo <= a and e <= hi)


def test_upload_needs_one_batch_of_free_memory(monkeypatch):
    """The need check counts the packed form and one batch's span, not the
    whole staged buffer: with just that much free the upload takes one
    batch a chunk (exact against the JAX pack), with a byte less it
    raises."""
    k, P, B = 25, 16, 4
    seqs = _sequences(2, k, P, n=12)
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    _seqs, batches = sortpipe.read_batches(None, seqs, cfg, RunStats())
    RW, NW = upload.row_words(batches.row_chars)
    out_bytes = len(batches) * B * (4 * (RW + NW) + 4)
    _chunks, least = upload.plan_chunks(batches.table, batches.row_chars, B,
                                        batches.codes.numel(), None)
    assert least < batches.codes.numel()
    monkeypatch.setattr(sortpipe, "_free_bytes", lambda dev: out_bytes + least)
    uploads = sortpipe.upload_batches(batches, CPU)
    _assert_matches_jax(seqs, k, P, B, batches, uploads)
    monkeypatch.setattr(sortpipe, "_free_bytes", lambda dev: out_bytes + least - 1)
    with pytest.raises(RuntimeError, match="the input's upload needs"):
        sortpipe.upload_batches(batches, CPU)


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, codes in records:
            f.write(f">{name} desc\n")
            text = "".join("ACGTN"[c] for c in codes)
            for i in range(0, len(text), 61):
                f.write(text[i : i + 61].lower() if i % 2 else text[i : i + 61])
                f.write("\n")


@pytest.mark.parametrize("native_io", ["1", "0"])
def test_upload_two_files_match_jax(tmp_path, monkeypatch, native_io):
    """Exact: two FASTA files read into one staged buffer (by the native
    encoder, or the numpy parser and a copy) give the JAX package's
    sequences, windows and pack."""
    monkeypatch.setenv("TWOPACO_NATIVE", native_io)
    k, P, B = 11, 32, 4
    seqs = _sequences(5, k, P, n=4)
    paths = [str(tmp_path / "a.fa"), str(tmp_path / "b.fa")]
    _write_fasta(paths[0], [(f"s{i}", c) for i, c in seqs[:6]])
    _write_fasta(paths[1], [(f"t{i}", c) for i, c in seqs[6:]])
    cfg = PipelineConfig(k=k, positions_per_row=P, rows_per_batch=B)
    got_seqs, batches = sortpipe.read_batches(paths, None, cfg, RunStats())
    jseqs = [(sid, c) for sid, _h, c in jfasta.read_all_records(paths)]
    assert [s for s, _c in got_seqs] == [s for s, _c in jseqs]
    for (_s, a), (_t, b) in zip(got_seqs, jseqs):
        np.testing.assert_array_equal(a, b)
    staged = batches.codes.numpy()
    assert len(staged) % fasta.STAGE_ALIGN == 0
    n = sum(len(c) for _s, c in jseqs)
    np.testing.assert_array_equal(staged[:n], np.concatenate([c for _s, c in jseqs]))
    uploads = sortpipe.upload_batches(batches, CPU)
    _assert_matches_jax(jseqs, k, P, B, batches, uploads)


def test_pack_rows_plain_any_table():
    """Exact: the plain pack on hand-made row tables (offsets before the
    buffer, unaligned, past its end; empty and clamped spans) against
    pack_codes_host of the rows gathered by hand."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=160).astype(np.uint8)
    R = 77
    table = np.array([[-5, 0, 160], [0, 0, 160], [3, 2, 100], [17, 20, 19], [150, 140, 160],
                      [90, -4, 400], [0, 0, 0], [-80, 0, 10]], np.int64)
    got_p, got_m = upload.pack_rows_plain(torch.from_numpy(codes), torch.from_numpy(table), R=R)
    rows = []
    for off, lo, hi in table:
        idx = off + np.arange(R)
        real = (idx >= max(lo, 0)) & (idx < min(hi, len(codes)))
        rows.append(np.where(real, codes[np.clip(idx, 0, len(codes) - 1)], 4))
    jp, jm = jpack.pack_codes_host(np.stack(rows).astype(np.uint8))
    np.testing.assert_array_equal(pack.as_i64(got_p).numpy(), jp.astype(np.int64))
    np.testing.assert_array_equal(pack.as_i64(got_m).numpy(), jm.astype(np.int64))
    assert upload.row_words(R) == (jp.shape[1], jm.shape[1])
    # a CPU tensor takes the plain version
    kp, km = upload.pack_rows(torch.from_numpy(codes), torch.from_numpy(table), R=R)
    assert torch.equal(kp.view(torch.int32), got_p.view(torch.int32))
    assert torch.equal(km.view(torch.int32), got_m.view(torch.int32))


def test_page_spans_lock_each_page_once():
    """Exact: the tensors hostmem.pinned page-locks become whole-page runs,
    tensors that share a page merged into one run (a page registered twice
    would fail), empty tensors none."""
    page = hostmem.mmap.PAGESIZE
    buf = hostmem.host_bytes(8 * page)
    base = buf.data_ptr()
    parts = [buf[10:20], buf[30 : page + 5], buf[3 * page + 1 : 4 * page], buf[:0],
             buf[6 * page : 8 * page].view(torch.int64)]
    first = base // page * page
    want = [[first, -(-(base + page + 5) // page) * page],
            [(base + 3 * page + 1) // page * page, -(-(base + 4 * page) // page) * page],
            [(base + 6 * page) // page * page, -(-(base + 8 * page) // page) * page]]
    got = hostmem._page_spans(parts)
    merged = []
    for a, b in want:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    assert got == merged
    with hostmem.pinned(parts, CPU):  # off a card: nothing locked
        pass


def test_pinned_registers_once_and_unlocks(monkeypatch):
    """hostmem.pinned on a card (its CUDA calls recorded here): each page
    run is registered once, a nested block over locked pages registers
    nothing, and every run is unregistered after a sync when its own
    block ends, an exception included."""
    calls = []

    class Rt:
        def cudaHostRegister(self, ptr, size, flags):
            calls.append(("register", ptr, size))
            return 0

        def cudaHostUnregister(self, ptr):
            calls.append(("unregister", ptr))
            return 0

    class Stream:
        def synchronize(self):
            calls.append(("sync",))

    monkeypatch.setattr(torch.cuda, "cudart", lambda: Rt())
    monkeypatch.setattr(torch.cuda, "check_error", lambda rc: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    cuda = torch.device("cuda")
    page = hostmem.mmap.PAGESIZE
    buf = hostmem.host_bytes(4 * page)
    base = buf.data_ptr()
    with hostmem.pinned([buf], cuda):
        with hostmem.pinned([buf[page : 2 * page], buf[:5]], cuda):
            pass
        assert hostmem._locked == [[base, base + 4 * page]]
    assert calls == [("register", base, 4 * page), ("sync",), ("sync",), ("unregister", base)]
    assert hostmem._locked == []
    calls.clear()
    with pytest.raises(RuntimeError, match="inside"):
        with hostmem.pinned([buf[page:]], cuda):
            raise RuntimeError("inside")
    assert calls == [("register", base + page, 3 * page), ("sync",), ("unregister", base + page)]
    assert hostmem._locked == []


@pytest.mark.parametrize("shape,dtype", [((0, 38), torch.uint32), ((), torch.int64),
                                         ((5, 3), torch.uint32), ((7,), torch.int32)])
def test_host_empty_shapes(shape, dtype):
    """Exact: host_empty gives the shape and dtype asked for (empty ones
    too), writable, in pages of its own when not empty."""
    t = hostmem.host_empty(shape, dtype)
    assert tuple(t.shape) == shape and t.dtype == dtype and t.is_contiguous()
    t.fill_(3)
    assert t.numel() == 0 or (int(t.reshape(-1)[0]) == 3
                              and t.data_ptr() % hostmem.mmap.PAGESIZE == 0)


def test_window_rows_no_rows():
    """Exact: only sequences shorter than k give no rows (an empty row
    table), and read_batches raises as before."""
    rows = windows.window_rows([0, 3, 4], windows.WindowConfig(5, 16, 4))
    assert len(rows) == 0 and rows.table.shape == (0, 3)
    cfg = PipelineConfig(k=5, positions_per_row=16, rows_per_batch=4)
    with pytest.raises(ValueError, match="no input sequence"):
        sortpipe.read_batches(None, [(0, np.zeros(4, np.uint8))], cfg, RunStats())


def test_main_path_packs_no_host_rows(tmp_path, monkeypatch):
    """The engines' front never cuts uint8 rows or packs on the host (the
    run completes with both refused; its bytes are held exactly by the
    tests above and tests/test_torch_merge.py)."""
    def refuse(*_a, **_kw):
        raise AssertionError("host windows or pack on the main path")

    monkeypatch.setattr(windows, "iter_window_batches", refuse)
    monkeypatch.setattr(pack, "pack_codes_host", refuse)
    seqs = _sequences(1, 11, 32, n=3)
    cfg = PipelineConfig(k=11, positions_per_row=32, rows_per_batch=4)
    out = str(tmp_path / "o.dbg")
    sortpipe.build_junctions_sorted(None, cfg, out, sequences=seqs, device="cpu")
    assert os.path.getsize(out) > 0
