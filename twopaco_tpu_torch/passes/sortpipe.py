"""Sort-join junction engine on one device, in one round or many.

The port of twopaco_tpu/passes/sortpipe.py:1008 build_junctions_sorted:

  1. host: read FASTA, cut window batches, pack them 2 bits a char plus
     an N mask, upload;
  2. device, per round: the round's records (one per vertex position
     whose hash lies in the round's interval) in a sort buffer, sorted by
     k-mer words (passes/sort.py), judged and compacted into the round's
     junction table and (position, +-id) occurrences (passes/judge.py),
     the occurrences sorted by position as u64 merge keys (passes/occ.py)
     when the merge will take its packed path, fetched;
  3. host: merge the rounds' tables into the sorted global dictionary,
     remap the round-local ids, merge the rounds' occurrences by position,
     and write the junction list with stubs.

Rounds split the hash space (the reference's -r semantics), so a round
holds about 1/R of the records. How a round's buffer is filled is the
mode:
  - one round: every batch's records straight into the buffer at
    row0 * P (passes/records.py);
  - resident: every record built once and split into per-round blocks
    held on the device (passes/partition.py); each round gathers its
    blocks;
  - grouped: resident, one group of rounds at a time, when all blocks
    exceed the resident budget;
  - stream: each round re-builds every batch's records gated to its
    interval and appends the in-round ones (passes/stream.py).
The environment picks among them as in the JAX package:
TWOPACO_RESIDENT=0 leaves resident mode, TWOPACO_GROUPED=0 leaves grouped
mode, TWOPACO_RESIDENT_BYTES sets the resident budget (default: the
device's free memory less one round's peak; on the CPU 6 GiB),
TWOPACO_UNIFORM_SPLIT=0 splits the hash space by a measured histogram
(passes/histogram.py) instead of uniformly, TWOPACO_POS64=1 forces the
wide merge layout of inputs of 2^32 or more slots.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.hostmem import big_empty
from twopaco_tpu_torch.io import fasta as fasta_io
from twopaco_tpu_torch.io import windows
from twopaco_tpu_torch.ops import pack
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes import histogram, judge, occ, partition, records, sort, stream
from twopaco_tpu_torch.passes.histogram import BIN_POW
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.pipeline import (
    Enumerator,
    PipelineConfig,
    RoundCheckpoint,
    RunStats,
    _input_fingerprint,
    _split_rounds,
    emit_junctions,
    emit_junctions_packed,
)

RESIDENT_BYTES_CPU = 6 << 30  # the JAX package's default budget
# the phase times every run reports, summed over rounds
PHASES = (
    "read", "windows", "upload", "hist", "partition", "build", "sort",
    "judge", "fetch", "merge", "emit",
)


@dataclass(frozen=True)
class Ops:
    """The device functions a run calls: the kernels' wrappers, or their
    plain PyTorch versions."""

    build: Callable
    sort: Callable
    judge: Callable
    partition: Callable
    assemble: Callable
    compact: Callable
    histogram: Callable
    occ: Callable


KERNELS = Ops(
    records.build_sort_records, sort.sort_records, judge.judge_compact,
    partition.partition_batch, partition.assemble_round,
    stream.compact_append, histogram.histogram_vertex_hashes_batches,
    occ.sort_occurrences,
)
PLAIN = Ops(
    records.build_sort_records_plain, sort.sort_records_plain,
    judge.judge_compact_plain, partition.partition_batch_plain,
    partition.assemble_round_plain, stream.compact_append_plain,
    histogram.histogram_vertex_hashes_batches_plain, occ.sort_occurrences_plain,
)


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
    """Device bytes a record slot of a round needs at the round's peak:
    the record (4w words + 4 payload + 8 position) twice around the sort
    with the sort's work (sort.work_bytes: two buffers of keys and of what
    travels with them, 40 bytes for w <= 2, 24 past it, and 2/3 of a byte
    of look-back status rounded up to 1, whose remainder covers the 4 KiB a
    word of histograms in any round of a batch or more); or the judge's 36
    bytes of work with the record and its table and occurrence outputs,
    whichever is larger."""
    rec = 4 * w + 12
    sort_slot = (40 if w <= 2 else 24) + -(-256 * 8 // sort.SORT_TILE)
    return max(2 * rec + sort_slot, rec + 36 + 4 * w + 12)


def block_bytes(w: int) -> int:
    """Device bytes of a resident block slot: w words, payload, u32
    in-batch offset."""
    return 4 * (w + 2)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free_bytes(dev: torch.device) -> int | None:
    """Free device memory, counting what PyTorch's allocator holds
    unused; None on the CPU (no limit is planned for)."""
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def plan_rounds(config: PipelineConfig, n_slots: int, bp: int, free: int | None):
    """-> (n_rounds, round_buf): the round count (at least -r) and the
    records a round's buffer may hold (twopaco_tpu sortpipe.py:1068-1089).

    The most records one round may sort is config.sort_chunk or, when it
    is None, what the free device memory holds: the whole input when it
    fits one round, else half the free memory's worth (the other half
    holds resident blocks). The judge's u32 scans cap it below 2^31."""
    w = config.w
    slack = config.round_slack
    max_sort = config.sort_chunk
    if max_sort is None:
        if free is None or n_slots * slot_bytes(w) <= free:
            max_sort = n_slots
        else:
            max_sort = free // (2 * slot_bytes(w))
            if max_sort < 2 * bp:
                raise RuntimeError(
                    f"the input needs at least {_gib(4 * bp * slot_bytes(w))} "
                    f"of free device memory for its smallest rounds; "
                    f"{_gib(free)} is free"
                )
    max_sort = max(1, min(max_sort, int(((1 << 31) - 4 * bp) / slack)))
    round_buf = min(n_slots, int(max_sort * slack) + bp) + bp
    capacity = max(1, int((round_buf - bp) / slack))
    if n_slots <= max_sort:
        n_rounds = max(config.rounds, 1)
    else:
        n_rounds = max(config.rounds, -(-n_slots // capacity))
    return n_rounds, round_buf


def resident_budget(config: PipelineConfig, n_slots: int, bp: int, n_rounds: int,
                    free: int | None) -> int:
    """Device bytes the resident blocks may take: TWOPACO_RESIDENT_BYTES,
    else the free memory less the peak of one round's sort and judge (on
    the CPU, the JAX package's 6 GiB)."""
    env = os.environ.get("TWOPACO_RESIDENT_BYTES")
    if env:
        return int(env)
    if free is None:
        return RESIDENT_BYTES_CPU
    round_slots = -(-int(n_slots * config.round_slack) // n_rounds) + bp
    return free - round_slots * slot_bytes(config.w)


def _plan_groups(hist, n_groups: int, n_inner: int, bin_pow: int):
    """Two-level greedy split of the hash space for the grouped mode:
    n_groups outer intervals (each sized so one group's blocks fit the
    resident budget), each split into up to n_inner inner rounds
    (twopaco_tpu sortpipe.py:1495).

    -> (groups, flat_intervals): groups[g] = (glow, ghigh, [(low, high,
    part_idx), ...]); flat_intervals lists every round's (low, high) in
    global round order (the checkpoint's identity)."""
    shift = 32 - bin_pow
    groups = []
    flat = []
    for gl, gh in _split_rounds(hist, n_groups, bin_pow):
        if gl > gh:
            continue
        sub = np.zeros_like(hist)
        sub[gl >> shift : (gh >> shift) + 1] = hist[gl >> shift : (gh >> shift) + 1]
        inner = []
        for lo, hi in _split_rounds(sub, n_inner, bin_pow):
            lo2, hi2 = max(lo, gl), min(hi, gh)
            if lo2 <= hi2:
                inner.append((lo2, hi2, len(inner)))
        if not inner:
            inner = [(gl, gh, 0)]
        groups.append((gl, gh, inner))
        flat.extend((lo, hi) for lo, hi, _p in inner)
    return groups, flat


def _live_intervals(hist, n_rounds: int):
    """_split_rounds without its inverted (empty) intervals: each would
    run a whole round of no records."""
    return [iv for iv in _split_rounds(hist, n_rounds, BIN_POW) if iv[0] <= iv[1]]


# ---- checkpoints -----------------------------------------------------


def _checkpoint_meta(config: PipelineConfig, n_slots: int, intervals, fingerprint) -> dict:
    # "torch-1": the port stores raw occurrences; a twopaco_tpu checkpoint
    # (version 2, 4-byte packed rounds) is cleared, never misread
    return dict(
        k=config.k,
        abundance=config.abundance,
        n_slots=int(n_slots),
        intervals=[list(map(int, iv)) for iv in intervals],
        fingerprint=fingerprint,
        version="torch-1",
    )


class _Checkpoint(RoundCheckpoint):
    """Sort-engine round checkpoint: each round's junction table and raw
    occurrences (twopaco_tpu sortpipe.py:901)."""

    def __init__(self, directory, config, n_slots, intervals, fingerprint=None,
                 read_only: bool = False):
        super().__init__(
            directory, _checkpoint_meta(config, n_slots, intervals, fingerprint),
            read_only=read_only,
        )

    def load_round(self, r: int):
        """-> ((table, occ_pos, occ_ids), rstats) or None."""
        got = super().load_round(r)
        if got is None:
            return None
        arrays, rstats = got
        return (arrays["table"], arrays["occ_pos"], arrays["occ_ids"]), rstats

    def save_round(self, r, entry, rstats) -> None:
        """Rounds are stored raw (sorted-key entries are decoded)."""
        table, occ_pos, occ_ids = raw_entry(entry)
        super().save_round(r, rstats, table=table, occ_pos=occ_pos, occ_ids=occ_ids)


def _complete_checkpoint_intervals(directory, config, n_slots, fingerprint):
    """Intervals of a COMPLETE matching checkpoint, else None
    (twopaco_tpu sortpipe.py:967).

    Matching: the stored meta.json equals what this run would write for
    every key but the interval list itself, which is the data being
    recovered (it can differ from a fresh split when the resident
    partition re-split on overflow). Complete: a round_<r>.npz exists for
    every stored interval."""
    meta_path = os.path.join(directory, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    ivs = meta.get("intervals")
    if not ivs or meta != _checkpoint_meta(config, n_slots, ivs, fingerprint):
        return None
    if not all(
        os.path.exists(os.path.join(directory, f"round_{r}.npz"))
        for r in range(len(ivs))
    ):
        return None
    return [tuple(iv) for iv in ivs]


# ---- the run ---------------------------------------------------------


def load_batches(input_paths, sequences, config: PipelineConfig, dev, stats: RunStats):
    """The host front of every engine: read the FASTA files (unless
    `sequences` is given), cut the window batches, pack them 2 bits a char
    plus an N mask (2.25 bits a char over the link) and upload them, with
    the `read`, `windows` and `upload` times in stats.

    -> (sequences, batches, uploads = [(packed, nmask, valid)] on dev)"""
    sequences, batches = read_batches(input_paths, sequences, config, stats)
    return sequences, batches, upload_batches(batches, dev, stats)


def read_batches(input_paths, sequences, config: PipelineConfig, stats: RunStats):
    """load_batches' host half: -> (sequences, window batches)."""
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
    if not batches:
        raise ValueError(f"no input sequence has {config.k} or more chars")
    return sequences, batches


def upload_batches(batches, dev, stats: RunStats, rows: slice = slice(None)):
    """The batches' rows `rows`, packed and uploaded to dev (the `upload`
    time is added to stats). -> [(packed, nmask, valid)]"""
    t0 = time.time()
    packed_np = [pack.pack_codes_host(b.codes[rows]) for b in batches]
    upload = sum(p.nbytes + m.nbytes for p, m in packed_np)
    free = _free_bytes(dev)
    if free is not None and upload > free:
        raise RuntimeError(
            f"the input's upload needs {_gib(upload)} of device memory, "
            f"{_gib(free)} is free"
        )
    uploads = [
        (
            torch.from_numpy(p).to(dev),
            torch.from_numpy(m).to(dev),
            torch.from_numpy(np.ascontiguousarray(b.valid[rows])).to(dev),
        )
        for (p, m), b in zip(packed_np, batches)
    ]
    _sync(dev)
    stats.timings["upload"] = stats.timings.get("upload", 0.0) + time.time() - t0
    return uploads


def build_junctions_sorted(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    *,
    device="cuda",
    reference: bool = False,
) -> Enumerator:
    """Find the junctions of the input and write the junction list.

    input_paths: FASTA files in reference CLI order, or `sequences` as
    [(seq_id, codes uint8)]. checkpoint_dir: round-boundary checkpoints;
    a rerun restores the rounds it finds. device: "cuda" runs the kernels
    and raises when there is no card; "cpu" runs the plain PyTorch
    versions. reference=True runs the plain versions on any device (to
    check the kernels against them on the card).
    """
    dev = resolve_device(device)
    ops = PLAIN if reference else KERNELS
    k, P, B, w = config.k, config.positions_per_row, config.rows_per_batch, config.w
    slack = config.round_slack
    stats = RunStats()
    stats.timings.update(dict.fromkeys(PHASES, 0.0))
    t_start = time.time()

    sequences, batches, uploads = load_batches(input_paths, sequences, config, dev, stats)
    bp = B * P
    nb = len(batches)
    n_slots = nb * bp
    # beyond 2^32 flat positions (~4.2 Gbases) the merge keys need more
    # than 32 position bits; TWOPACO_POS64=1 forces that layout for tests
    wide = wide_layout(config, n_slots)
    id_bits = key_id_bits(n_slots, len(sequences), wide)
    log(
        f"Engine = sort-join ({dev.type})\nVertex length = {k}\n"
        f"Record slots = {n_slots}\nCapacity = {w} words"
    )
    bases = [b.row0 * P for b in batches]

    free = _free_bytes(dev)
    n_rounds, round_buf = plan_rounds(config, n_slots, bp, free)
    budget = resident_budget(config, n_slots, bp, n_rounds, free)
    total_bytes = int(n_slots * slack * block_bytes(w))
    resident = (
        n_rounds > 1
        and total_bytes <= budget
        and os.environ.get("TWOPACO_RESIDENT", "1") != "0"
    )
    hist = None
    if n_rounds > 1:
        t0 = time.time()
        if os.environ.get("TWOPACO_UNIFORM_SPLIT", "1") != "0":
            # Buzhash values are near-uniform: a uniform split of the hash
            # space balances the rounds to ~sqrt(records a round), and the
            # resident partition re-splits on overflow anyway
            hist = np.ones(1 << BIN_POW, np.int64)
        else:
            # a sample of ~2^23 positions: ~1% interval-mass accuracy
            stride = max(1, 1 << max(0, n_slots.bit_length() - 24))
            hist = histogram.histogram_scan(uploads, k=k, P=P, stride=stride, fn=ops.histogram)
        stats.timings["hist"] = time.time() - t0

    fingerprint = None
    if checkpoint_dir is not None:
        fingerprint = _input_fingerprint(input_paths, sequences)

    blocks = None  # resident blocks: (words, payload, offset) stacked
    groups = None  # grouped plan
    n_inner = part_cap = 0
    resumed_all = False
    if resident and checkpoint_dir is not None:
        # a COMPLETE matching checkpoint holds the final (re-split)
        # intervals: restore every round without the partition pass
        resume_iv = _complete_checkpoint_intervals(checkpoint_dir, config, n_slots, fingerprint)
        if resume_iv is not None:
            intervals = resume_iv
            buf_slots = 0
            del uploads
            resident = False  # the round loop must not touch blocks
            resumed_all = True
            log(f"All {len(intervals)} resident rounds checkpointed — skipping partition")
    if resumed_all:
        pass
    elif resident:
        t0 = time.time()
        n_rounds = max(config.rounds, -(-int(n_slots * slack) // round_buf))
        for _attempt in range(6):
            intervals = _live_intervals(hist, n_rounds)
            part_cap = -(-int(slack * bp) // len(intervals))
            highs = [h for _l, h in intervals]
            *blocks, counts = partition.partition_scan(
                uploads, highs, 0, MASK32, k=k, P=P, part_cap=part_cap,
                fn=ops.partition,
            )
            if (counts <= part_cap).all():
                break
            # a batch's round block overflowed its fixed cap (local k-mer
            # hash skew): split finer and partition again
            blocks = None
            n_rounds = -(-n_rounds * 3) // 2
            log(
                f"Round block overflow (max {int(counts.max())} > {part_cap}); "
                f"re-splitting into {n_rounds} rounds"
            )
        else:
            raise RuntimeError(
                "round block overflow persists after re-splitting — raise "
                "PipelineConfig.round_slack"
            )
        del uploads  # the records live in the blocks now
        buf_slots = nb * part_cap
        _sync(dev)
        stats.timings["partition"] = time.time() - t0
        log(
            f"Splitting the input kmers set ({len(intervals)} rounds, "
            f"resident parts, block cap {part_cap})"
        )
    elif n_rounds > 1 and os.environ.get("TWOPACO_GROUPED", "1") != "0":
        # one partition pass per group of rounds, each group's blocks
        # resident while its rounds run
        n_groups = min(max(2, -(-total_bytes // max(budget, 1))), n_rounds)
        n_inner = -(-n_rounds // n_groups)
        groups, intervals = _plan_groups(hist, n_groups, n_inner, BIN_POW)
        part_cap = -(-int(slack * bp) // (len(groups) * n_inner))
        buf_slots = nb * part_cap
        log(
            f"Splitting the input kmers set ({len(intervals)} rounds in "
            f"{len(groups)} resident groups, block cap {part_cap})"
        )
    elif n_rounds > 1:
        intervals = _live_intervals(hist, n_rounds)
        # a round's share of the records with the slack, plus one batch of
        # append headroom
        buf_slots = min(round_buf, -(-int(n_slots * slack) // len(intervals)) + bp)
        log(f"Splitting the input kmers set ({len(intervals)} rounds)")
    else:
        intervals = [(0, MASK32)]
        buf_slots = n_slots  # every batch at row0 * P

    ckpt = _Checkpoint(checkpoint_dir, config, n_slots, intervals, fingerprint)
    bases_d = torch.tensor(bases, dtype=torch.int64, device=dev)

    # grouped bookkeeping: round -> block index within its group, and the
    # rounds at which a group's partition pass runs
    part_of_round: list[int] = []
    group_at: dict[int, tuple] = {}
    for glow, ghigh, g_rounds in groups or ():
        group_at[len(part_of_round)] = (
            glow, ghigh, [hi for _l, hi, _p in g_rounds], len(g_rounds),
        )
        part_of_round.extend(p for _l, _h, p in g_rounds)

    fetched = []
    for r, (low, high) in enumerate(intervals):
        if r in group_at:
            glow, ghigh, g_highs, n_real = group_at[r]
            if not all(ckpt.has_round(r + j) for j in range(n_real)):
                blocks = None  # the previous group's blocks go first
                t0 = time.time()
                *blocks, counts = partition.partition_scan(
                    uploads, g_highs + [ghigh] * (n_inner - n_real), glow, ghigh,
                    k=k, P=P, part_cap=part_cap, fn=ops.partition,
                )
                if (counts[:, :n_real] > part_cap).any():
                    raise RuntimeError(
                        f"grouped round block overflow (max {int(counts.max())} "
                        f"> {part_cap}) — raise PipelineConfig.round_slack"
                    )
                _sync(dev)
                stats.timings["partition"] += time.time() - t0
        restored = ckpt.load_round(r)
        if restored is not None:
            entry, rstats = restored
            fetched.append(entry)
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        if resumed_all:
            # every round file was there a moment ago; the blocks and the
            # upload are released, so the round cannot be computed
            raise RuntimeError(f"checkpoint round {r} disappeared during resume")
        log(f"Round {r}, {low}:{high}")
        t0 = time.time()
        if resident or groups is not None:
            pidx = r if resident else part_of_round[r]
            buf = ops.assemble(pidx, *blocks, bases_d, buf_slots)
        elif len(intervals) == 1:
            buf = (
                torch.empty((n_slots, w), dtype=torch.uint32, device=dev),
                torch.empty(n_slots, dtype=torch.uint32, device=dev),
                torch.empty(n_slots, dtype=torch.int64, device=dev),
            )
            for (codes_p, nmask, valid), off in zip(uploads, bases):
                out = tuple(t[off : off + bp] for t in buf)
                ops.build(codes_p, nmask, valid, off, k=k, P=P, low=low, high=high, out=out)
        else:
            *buf, over = stream.stream_round(
                uploads, bases, low, high, k=k, P=P, buf_slots=buf_slots,
                build_fn=ops.build, compact_fn=ops.compact,
            )
            if over:
                raise RuntimeError(
                    "round record buffer overflow — increase rounds (-r) or "
                    "PipelineConfig.round_slack"
                )
        _sync(dev)
        t_build = time.time() - t0

        t0 = time.time()
        sw, spay, spos = ops.sort(*buf, key_bits=2 * k)
        del buf
        _sync(dev)
        t_sort = time.time() - t0

        t0 = time.time()
        table_d, occ_pos_d, occ_id_d, n_groups, n_junc, n_occ = ops.judge(
            sw, spay, spos, config.abundance
        )
        del sw, spay, spos
        occ_d = finish_occurrences(ops, occ_pos_d, occ_id_d, id_bits, n_slots)
        del occ_pos_d, occ_id_d
        _sync(dev)
        t_judge = time.time() - t0

        t0 = time.time()
        entry = fetch_entry(table_d, occ_d, id_bits)
        del table_d, occ_d
        t_fetch = time.time() - t0
        fetched.append(entry)
        stats.rounds.append(
            dict(
                low=low, high=high, marks=n_occ, hash_table_size=n_groups,
                true_junctions=n_junc, false_positives=0, t_build=t_build,
                t_sort=t_sort, t_judge=t_judge, t_fetch=t_fetch,
            )
        )
        for key, val in (("build", t_build), ("sort", t_sort),
                         ("judge", t_judge), ("fetch", t_fetch)):
            stats.timings[key] += val
        log(
            f"Round {r} seconds: build={t_build:.4f} sort={t_sort:.4f} "
            f"judge={t_judge:.4f} fetch={t_fetch:.4f}\n"
            f"True junctions = {n_junc}\nDistinct k-mers = {n_groups}\n"
            f"Occurrences = {n_occ}"
        )
        ckpt.save_round(r, entry, stats.rounds[-1])

    blocks = uploads = None  # release the device state before the host tail
    return merge_fetched(
        fetched, batches, config, out_path, stats, log, t_start,
        n_slots=n_slots, wide=wide, n_sequences=len(sequences),
    )


# ---- the host tail ---------------------------------------------------


def wide_layout(config: PipelineConfig, n_slots: int) -> bool:
    """Beyond 2^32 flat positions (~4.2 Gbases) the merge keys need more
    than 32 position bits; TWOPACO_POS64=1 (or config.force_wide) forces
    that layout on any input, for tests."""
    return (
        n_slots >= 1 << 32
        or config.force_wide
        or os.environ.get("TWOPACO_POS64") == "1"
    )


def merge_pos_bits(n_slots: int, wide: bool) -> int:
    """Position bits of the merge's u64 keys (the rest hold the id)."""
    return 32 if not wide else max(n_slots.bit_length(), 33)


def _packed_merge(total_j: int, n_sequences: int, id_bits: int) -> bool:
    """The merge takes its packed u64 path: every global id, stubs
    included, fits id_bits - 1 bits."""
    return total_j + 2 * n_sequences + 64 < (1 << (id_bits - 1))


def key_id_bits(n_slots: int, n_sequences: int, wide: bool) -> int | None:
    """id_bits of the sorted u64 keys a round hands the merge
    (passes/occ.py), or None when the round stays raw: keys only when the
    merge takes its packed path whatever the junction count (at most one
    junction a slot)."""
    id_bits = 64 - merge_pos_bits(n_slots, wide)
    return id_bits if _packed_merge(n_slots, n_sequences, id_bits) else None


def finish_occurrences(ops, occ_pos, occ_id, id_bits: int | None, n_slots: int):
    """A judged round's occurrences as the merge takes them, on the
    device: (keys, bad) from ops.occ when id_bits is set, else (occ_pos,
    occ_id) as they are."""
    if id_bits is None:
        return occ_pos, occ_id
    return ops.occ(occ_pos, occ_id, id_bits=id_bits, pos_limit=n_slots)


def fetch_entry(table_d, occ_d, id_bits: int | None):
    """The merge entry of a judged round (D2H): (table, occ_pos, occ_ids)
    raw, or (table, OccKeys, None) for sorted keys; raises when the
    occurrence sort flagged a position or id that does not fit its key."""
    a, b = occ_d
    table = table_d.cpu().numpy()
    if id_bits is None:
        return table, a.cpu().numpy(), b.cpu().numpy()
    if int(b):
        raise RuntimeError(
            f"{int(b)} occurrences with a position or id outside the merge key "
            "(corrupt round)"
        )
    return table, OccKeys(a.cpu().numpy().view(np.uint64), id_bits), None


def raw_entry(entry):
    """-> (table, occ_pos int64, signed local ids) of any merge entry."""
    table, occ_pos, occ_ids = entry
    if isinstance(occ_pos, OccKeys):
        occ_pos, occ_ids = occ_pos.decode()
    return table, occ_pos, occ_ids


def merge_fetched(
    fetched, batches, config, out_path, stats, log, t_start,
    *, n_slots: int, wide: bool, n_sequences: int,
) -> Enumerator:
    """Merge the rounds and write the junction list (twopaco_tpu
    sortpipe.py:1467). fetched = one entry a round (or a shard's block of
    one): (table (nj, w) uint32 sorted, occ_pos int64, occ_ids = +-(1-based
    row of table)) raw, or (table, OccKeys, None) with the occurrences as
    position-sorted u64 keys (passes/occ.py); the entries' k-mer sets are
    disjoint. Picks the packed u64 merge when every id and position fits
    one key, else the unpacked int64 merge.

    u64 keys: position in the high pos_bits, biased signed id below.
    Inputs under 2^32 slots split 32/32 (u32 views: fast paths); wide
    runs split at the position width while the ids still fit."""
    total_j = sum(len(e[0]) for e in fetched)
    pos_bits = merge_pos_bits(n_slots, wide)
    if _packed_merge(total_j, n_sequences, 64 - pos_bits):
        return merge_rounds_packed(
            fetched, batches, config, out_path, stats, log, t_start,
            pos_bits=pos_bits,
        )
    raw = [raw_entry(e) for e in fetched]
    return merge_rounds_and_emit(
        [t for t, _, _ in raw], [(p, i) for _, p, i in raw],
        batches, config, out_path, stats, log, t_start,
    )


def _merge_keys(cat: np.ndarray, w: int) -> np.ndarray:
    """Sort/search keys for (n, w) canonical k-mer word rows: u64 keys
    when they fit (k <= 31, the same lexicographic order and much faster
    than byte strings), else byte-string keys (twopaco_tpu
    sortpipe.py:1526)."""
    if w == 1:
        return cat[:, 0].astype(np.uint64)
    if w == 2:
        return (cat[:, 0].astype(np.uint64) << 32) | cat[:, 1].astype(np.uint64)
    return dna.words_to_bytes_keys(cat)


def merge_rounds_packed(
    fetched, batches, config, out_path, stats, log, t_start, pos_bits: int = 32,
) -> Enumerator:
    """Merge into ONE u64 key buffer (pos << id_bits | id + 2^(id_bits-1),
    id_bits = 64 - pos_bits), sorted in place (twopaco_tpu
    sortpipe.py:1539). The global table is the rounds' tables sorted; the
    keys are unique (rounds partition the k-mer space), so the inverse of
    that sort remaps each round's local ids with no search. Raises on
    duplicate keys across rounds, on an id past its round's table, on id
    0, and on a position past pos_bits."""
    id_bits = 64 - pos_bits
    t0 = time.time()
    table, inv = merge_tables(fetched, config.w)
    buf = packed_occurrences(fetched, inv, pos_bits)
    # sorted-key entries arrive as sorted runs: timsort ("stable") merges
    # them, 5-10x faster than the default quicksort here (PERF.md)
    buf.sort(kind="stable")
    stats.timings["merge"] = time.time() - t0

    stats.distinct_junctions = len(table)
    enum = Enumerator(table, config.k, stats)
    if out_path is not None:
        t0 = time.time()
        occurrences, n_stubs = emit_junctions_packed(
            out_path, batches, buf, len(table), config.positions_per_row,
            timings=stats.timings, id_bits=id_bits,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        log(f"True marks count: {occurrences}")
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum


def merge_tables(fetched, w: int):
    """-> (the global table: the entries' tables sorted, inv: entry table
    row (concatenated in entry order) -> global row). Raises on a k-mer in
    two entries."""
    tables = [t for t, _, _ in fetched if len(t)]
    if not tables:
        return np.zeros((0, w), np.uint32), np.zeros(0, np.int64)
    cat = np.concatenate(tables)
    keys = _merge_keys(cat, w)
    order = np.argsort(keys)
    sorted_keys = keys[order]
    if len(sorted_keys) > 1 and not bool((sorted_keys[1:] > sorted_keys[:-1]).all()):
        raise AssertionError(
            "duplicate junction keys across rounds — hash intervals "
            "must partition the k-mer space"
        )
    inv = np.empty(len(keys), np.int64)
    inv[order] = np.arange(len(keys), dtype=np.int64)
    return np.ascontiguousarray(cat[order]), inv


def packed_occurrences(fetched, inv, pos_bits: int) -> np.ndarray:
    """Every entry's occurrences as u64 keys with global ids, unsorted
    across entries: (n_occ,) uint64. inv maps the entries' concatenated
    table rows to global rows. A raw entry's keys are built here; a
    sorted-key entry only has its low id_bits rewritten, so it stays one
    position-sorted run."""
    id_bits = 64 - pos_bits
    id_mask = np.uint64((1 << id_bits) - 1)
    buf = big_empty(sum(len(e[1]) for e in fetched), np.uint64)
    ofs = row_ofs = 0
    bias = np.int64(1) << (id_bits - 1)
    for rtab, pos, oi in fetched:
        remap = inv[row_ofs : row_ofs + len(rtab)]
        row_ofs += len(rtab)
        n = len(pos)
        if n == 0:
            continue
        seg64 = buf[ofs : ofs + n]
        keyed = isinstance(pos, OccKeys)
        if keyed:
            if pos.id_bits != id_bits:
                raise ValueError(f"keys of {pos.id_bits} id bits in a {id_bits}-bit merge")
            seg64[:] = pos.keys
            if id_bits == 32:  # little-endian: u32 [0] = id
                oi = seg64.view(np.uint32).reshape(-1, 2)[:, 0].astype(np.int64) - bias
            else:
                oi = (seg64 & id_mask).view(np.int64) - bias
        idx = np.abs(oi.astype(np.int64)) - 1
        # a corrupt id would otherwise point at a plausible junction
        if int(idx.max()) >= len(remap):
            raise RuntimeError(
                f"occurrence id out of range: max index {int(idx.max())} >= "
                f"table size {len(remap)}"
            )
        if int(idx.min()) < 0:
            raise RuntimeError("occurrence id 0 (corrupt round)")
        if not keyed and (int(pos.max()) >> pos_bits or int(pos.min()) < 0):
            raise RuntimeError(f"occurrence position outside {pos_bits} bits")
        gid = remap[idx] + 1
        np.negative(gid, where=oi < 0, out=gid)
        gid += bias
        if pos_bits == 32:
            # the two u32 halves through a view (little-endian: [0] = id)
            seg = seg64.view(np.uint32).reshape(-1, 2)
            if not keyed:
                seg[:, 1] = pos
            seg[:, 0] = gid
        else:
            if keyed:
                np.bitwise_and(seg64, ~id_mask, out=seg64)
            else:
                np.left_shift(pos.astype(np.int64).view(np.uint64), np.uint64(id_bits),
                              out=seg64)
            np.bitwise_or(seg64, gid.view(np.uint64), out=seg64)
        ofs += n
    return buf


def merge_rounds_and_emit(
    round_tables, round_occ, batches, config, out_path, stats, log, t_start,
) -> Enumerator:
    """The unpacked merge (twopaco_tpu sortpipe.py:1677): the rounds'
    tables merged into the global sorted dictionary, local ids remapped
    by search, occurrences as int64 (position, id) pairs sorted by
    position. round_occ[r] = (occ_pos, signed local ids, |id| = 1-based
    row of round_tables[r]), in any order."""
    t0 = time.time()
    w = config.w
    if sum(len(t) for t in round_tables):
        cat = np.concatenate([t for t in round_tables if len(t)])
        keys = _merge_keys(cat, w)
        order = np.argsort(keys, kind="stable")
        table = np.ascontiguousarray(cat[order])
        global_keys = keys[order]
    else:
        table = np.zeros((0, w), np.uint32)
        global_keys = _merge_keys(table, w)

    all_pos, all_ids = [], []
    for rtab, (op, oi) in zip(round_tables, round_occ):
        if len(op) == 0:
            continue
        remap = np.searchsorted(global_keys, _merge_keys(rtab, w)).astype(np.int64)
        gid = remap[np.abs(oi.astype(np.int64)) - 1] + 1
        all_pos.append(op.astype(np.int64))
        all_ids.append(np.sign(oi).astype(np.int64) * gid)
    if all_pos:
        occ_pos = np.concatenate(all_pos)
        occ_ids = np.concatenate(all_ids)
        order = np.argsort(occ_pos, kind="stable")
        occ_pos, occ_ids = occ_pos[order], occ_ids[order]
    else:
        occ_pos = occ_ids = np.zeros(0, np.int64)
    stats.timings["merge"] = time.time() - t0
    return finish_emit(table, occ_pos, occ_ids, batches, config, out_path, stats, log, t_start)


def finish_emit(
    table, occ_pos, occ_ids, batches, config, out_path, stats, log, t_start,
) -> Enumerator:
    """Common tail of the unpacked merge (twopaco_tpu sortpipe.py:1747):
    the Enumerator of the global table, and the junction list written
    from the position-sorted occurrence stream."""
    stats.distinct_junctions = len(table)
    enum = Enumerator(table, config.k, stats)
    if out_path is not None:
        t0 = time.time()
        occurrences, n_stubs = emit_junctions(
            out_path, batches, occ_pos, occ_ids, len(table),
            config.positions_per_row, timings=stats.timings,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        log(f"True marks count: {occurrences}")
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
