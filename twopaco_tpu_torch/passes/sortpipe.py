"""Sort-join junction engine, one device, one round.

The port of twopaco_tpu/passes/sortpipe.py:1008 build_junctions_sorted
in its single-round form (:1253-1262, :1355-1358 _stream_single_round):

  1. host: read FASTA, cut window batches, pack them 2 bits a char plus
     an N mask, upload;
  2. device: build one record per vertex position straight into the
     round buffer (passes/records.py), sort the round by k-mer words
     (passes/sort.py), judge k-mer groups and compact the junction table
     and the (position, +-id) occurrences (passes/judge.py);
  3. host: fetch, pack occurrences into u64 keys (position << 32 | biased
     id), sort them, and write the junction list with stubs
     (pipeline.emit_junctions_packed).

The round holds the whole input. Its size comes from the device's free
memory (torch.cuda.mem_get_info); an input that does not fit, or -r
above 1, raises: the multi-round modes are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from twopaco_tpu_torch.hostmem import big_empty
from twopaco_tpu_torch.io import fasta as fasta_io
from twopaco_tpu_torch.io import windows
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.passes import judge, records, sort
from twopaco_tpu_torch.passes.pipeline import (
    Enumerator,
    PipelineConfig,
    RunStats,
    emit_junctions_packed,
)

MULTI_ROUND_ITEM = "ROADMAP item A4, multi-round modes"


class MultiRoundUnsupported(ValueError):
    pass


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request on a host without a
    usable card raises (the port never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; the port does not fall back to the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def slot_bytes(w: int) -> int:
    """Device bytes a record slot needs at the round's peak: the record
    (4w words + 4 payload + 8 position) twice around the sort, the sort's
    24 bytes of keys and indices, then the judge's 36 bytes of work plus
    its table and occurrence outputs."""
    rec = 4 * w + 12
    return max(2 * rec + 24, rec + 36 + 4 * w + 12)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_fits(n_slots: int, w: int, dev: torch.device, upload: int) -> None:
    if n_slots >= 1 << 31:
        raise MultiRoundUnsupported(
            f"{n_slots} record slots exceed one round's u32 indices; "
            f"split runs are {MULTI_ROUND_ITEM}, not ported yet"
        )
    if dev.type != "cuda":
        return
    free, _total = torch.cuda.mem_get_info(dev)
    need = n_slots * slot_bytes(w) + upload
    if need > free:
        raise MultiRoundUnsupported(
            f"one round needs {need / 2**30:.2f} GiB of device memory, "
            f"{free / 2**30:.2f} GiB is free; split runs are "
            f"{MULTI_ROUND_ITEM}, not ported yet"
        )


def build_junctions_sorted(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    *,
    device="cuda",
    reference: bool = False,
) -> Enumerator:
    """Find the junctions of the input and write the junction list.

    input_paths: FASTA files in reference CLI order, or `sequences` as
    [(seq_id, codes uint8)]. device: "cuda" runs the kernels and raises
    when there is no card; "cpu" runs the plain PyTorch versions.
    reference=True runs the plain versions on any device (to check the
    kernels against them on the card).
    """
    if config.rounds > 1:
        raise MultiRoundUnsupported(
            f"-r {config.rounds}: runs of more than one round are "
            f"{MULTI_ROUND_ITEM}, not ported yet"
        )
    dev = resolve_device(device)
    if reference:
        build_fn, sort_fn, judge_fn = (
            records.build_sort_records_plain,
            sort.sort_records_plain,
            judge.judge_compact_plain,
        )
    else:
        build_fn, sort_fn, judge_fn = (
            records.build_sort_records,
            sort.sort_records,
            judge.judge_compact,
        )
    k, P, B, w = config.k, config.positions_per_row, config.rows_per_batch, config.w
    stats = RunStats()
    t_start = time.time()

    t0 = time.time()
    if sequences is None:
        sequences = [
            (sid, codes)
            for sid, _hdr, codes in fasta_io.read_all_records(input_paths)
        ]
    stats.timings["read"] = time.time() - t0
    t0 = time.time()
    batches = list(windows.iter_window_batches(iter(sequences), config.window_config()))
    stats.total_positions = sum(int(b.valid.sum()) for b in batches)
    stats.timings["windows"] = time.time() - t0
    bp = B * P
    n_slots = len(batches) * bp
    log(
        f"Engine = sort-join ({dev.type})\nVertex length = {k}\n"
        f"Record slots = {n_slots}\nCapacity = {w} words"
    )

    # 2-bit packed chars + N bitmask: 2.25 bits a char over the link
    t0 = time.time()
    packed_np = [pack.pack_codes_host(b.codes) for b in batches]
    upload = sum(p.nbytes + m.nbytes for p, m in packed_np)
    _check_fits(n_slots, w, dev, upload)
    packed = [
        (
            torch.from_numpy(p).to(dev),
            torch.from_numpy(m).to(dev),
            torch.from_numpy(b.valid).to(dev),
        )
        for (p, m), b in zip(packed_np, batches)
    ]
    del packed_np
    _sync(dev)
    stats.timings["upload"] = time.time() - t0

    t0 = time.time()
    buf_w = torch.empty((n_slots, w), dtype=torch.uint32, device=dev)
    buf_pay = torch.empty(n_slots, dtype=torch.uint32, device=dev)
    buf_pos = torch.empty(n_slots, dtype=torch.int64, device=dev)
    for (codes_p, nmask, valid), b in zip(packed, batches):
        off = b.row0 * P  # each batch fills its own B*P slots
        out = (buf_w[off : off + bp], buf_pay[off : off + bp], buf_pos[off : off + bp])
        build_fn(codes_p, nmask, valid, off, k=k, P=P, out=out)
    del packed
    _sync(dev)
    stats.timings["build"] = time.time() - t0

    t0 = time.time()
    sw, spay, spos = sort_fn(buf_w, buf_pay, buf_pos)
    del buf_w, buf_pay, buf_pos
    _sync(dev)
    stats.timings["sort"] = time.time() - t0

    t0 = time.time()
    table_d, occ_pos_d, occ_id_d, n_groups, n_junc, n_occ = judge_fn(
        sw, spay, spos, config.abundance
    )
    del sw, spay, spos
    _sync(dev)
    stats.timings["judge"] = time.time() - t0

    t0 = time.time()
    table = table_d.cpu().numpy()
    occ_pos = occ_pos_d.cpu().numpy()
    occ_id = occ_id_d.cpu().numpy()
    del table_d, occ_pos_d, occ_id_d
    stats.timings["fetch"] = time.time() - t0
    stats.rounds.append(
        dict(
            low=0, high=0xFFFFFFFF, marks=n_occ, hash_table_size=n_groups,
            true_junctions=n_junc, false_positives=0,
        )
    )
    log(
        f"True junctions = {n_junc}\nDistinct k-mers = {n_groups}\n"
        f"Occurrences = {n_occ}"
    )
    return merge_fetched(
        table, occ_pos, occ_id, batches, config, out_path, stats, log, t_start
    )


def merge_fetched(
    table, occ_pos, occ_id, batches, config, out_path, stats, log, t_start
) -> Enumerator:
    """Host tail of the round: the junction table is already the sorted
    global dictionary, and occurrence ids are +-(row + 1) into it. Pack
    each occurrence into one u64 key, position << 32 | (id + 2^31), sort
    the keys, and emit (twopaco_tpu sortpipe.py:1467 merge_fetched and
    :1539 merge_rounds_packed with one round: the remap is the
    identity)."""
    t0 = time.time()
    n = len(occ_id)
    if n:
        idx = np.abs(occ_id.astype(np.int64)) - 1
        # a corrupt id would otherwise point at a plausible junction
        if int(idx.max()) >= len(table) or int(idx.min()) < 0:
            raise RuntimeError(
                f"occurrence id out of range: |id| in "
                f"[{int(idx.min()) + 1}, {int(idx.max()) + 1}], "
                f"table size {len(table)}"
            )
    keys = big_empty(n, np.uint64)
    halves = keys.view(np.uint32).reshape(-1, 2)  # little-endian: [0] = low
    halves[:, 1] = occ_pos  # flat positions < 2^32 (one round)
    halves[:, 0] = occ_id.astype(np.int64) + (1 << 31)
    keys.sort()
    stats.timings["merge"] = time.time() - t0

    stats.distinct_junctions = len(table)
    enum = Enumerator(np.ascontiguousarray(table), config.k, stats)
    if out_path is not None:
        t0 = time.time()
        occurrences, n_stubs = emit_junctions_packed(
            out_path, batches, keys, len(table), config.positions_per_row,
            timings=stats.timings,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        log(f"True marks count: {occurrences}")
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
