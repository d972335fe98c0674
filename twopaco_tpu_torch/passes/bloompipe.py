"""Bloom junction engine on one device (`--tpu-engine bloom`).

The port of twopaco_tpu/passes/pipeline.py:639-924, the reference
TwoPaCo's own algorithm (vertexenumerator.h:122-466):

  1. host: read, window batches and upload, as the sort engine does them
     (sortpipe.load_batches);
  2. device, per round (a vertex-hash interval, the reference's -r):
     fill   a 2^f-slot Bloom filter with the canonical edges of every
            position in the round (passes/fill.py);
     mark   the candidate positions: a vertex with more than one in- or
            out-extension in the filter (passes/mark.py), kept for pass 4;
     extract the candidates' records into the round's buffer
            (passes/extract.py);
     verify them exactly: the sort engine's sort and judge
            (passes/sort.py, passes/judge.py), whose junction table is
            the round's junctions;
  3. host: the rounds' junctions into one sorted dictionary;
  4. device, per batch: the ids of the candidate positions found in the
     dictionary (passes/lookup.py), then the junction list written with
     stubs (pipeline.emit_junctions).

TWOPACO_UNIFORM_SPLIT=0 splits the hash space by a measured histogram
(passes/histogram.py) instead of uniformly; TWOPACO_MASK_SPILL_BYTES
(default 1 GiB) bounds the candidate masks kept between pass 2 and pass
4, above which each round's masks go to a file in tmpdir.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from twopaco_tpu_torch import dna
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes import extract, fill, histogram, judge, lookup, mark, sort
from twopaco_tpu_torch.passes.histogram import BIN_POW
from twopaco_tpu_torch.passes.pipeline import (
    Enumerator,
    PipelineConfig,
    RoundCheckpoint,
    RunStats,
    _input_fingerprint,
    _split_rounds,
    emit_junctions,
)
from twopaco_tpu_torch.passes.sortpipe import _sync, load_batches, resolve_device

# the phase times every run reports, summed over rounds
PHASES = (
    "read", "windows", "upload", "hist", "fill", "mark", "extract", "verify",
    "dict", "lookup", "emit",
)


@dataclass(frozen=True)
class Ops:
    """The device functions a run calls: the kernels' wrappers, or their
    plain PyTorch versions."""

    fill: Callable
    mark: Callable
    extract: Callable
    sort: Callable
    judge: Callable
    lookup: Callable
    histogram: Callable


KERNELS = Ops(
    fill.bloom_fill, mark.bloom_mark, extract.extract_records, sort.sort_records,
    judge.judge_compact, lookup.pass4_lookup, histogram.histogram_vertex_hashes_batches,
)
PLAIN = Ops(
    fill.bloom_fill_plain, mark.bloom_mark_plain, extract.extract_records_plain,
    sort.sort_records_plain, judge.judge_compact_plain, lookup.pass4_lookup_plain,
    histogram.histogram_vertex_hashes_batches_plain,
)


class MaskStore:
    """Each round's packed candidate masks, kept for pass 4 (twopaco_tpu
    pipeline.py:291 _MaskStore; the reference's candidate_<round>.tmp
    files, vertexenumerator.h:485-490). Up to TWOPACO_MASK_SPILL_BYTES of
    masks in the run (default 1 GiB) they stay where they are, on the
    device; above it each round's are written once to a .npy file in a
    fresh directory under tmpdir and read back memory-mapped."""

    def __init__(self, tmpdir: str | None, est_bytes: int):
        budget = int(os.environ.get("TWOPACO_MASK_SPILL_BYTES", str(1 << 30)))
        self.dir = (
            tempfile.mkdtemp(prefix="twopaco_masks_", dir=tmpdir)
            if est_bytes > budget else None
        )
        self._rounds: list = []  # per round: a list of masks, or a path
        self._views = None  # pass 4's view of every round

    def add_round(self, masks) -> None:
        """masks: the round's per-batch (B, P/8) uint8 masks (tensors or
        arrays)."""
        if self.dir is None or not len(masks):
            self._rounds.append(masks)
            return
        path = os.path.join(self.dir, f"candidate_{len(self._rounds)}.npy")
        np.save(path, np.stack([np.asarray(torch.as_tensor(m).cpu()) for m in masks]))
        self._rounds.append(path)

    def batch_mask(self, bi: int, device) -> torch.Tensor:
        """The OR of every round's mask of batch bi, on `device`."""
        if self._views is None:
            self._views = [
                np.load(e, mmap_mode="r") if isinstance(e, str) else e for e in self._rounds
            ]
        out = None
        for rm in self._views:
            m = rm[bi]
            m = (torch.from_numpy(np.array(m)) if isinstance(m, np.ndarray) else m).to(device)
            out = m.clone() if out is None else out.bitwise_or_(m)
        return out

    def cleanup(self) -> None:
        self._rounds = []
        self._views = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


def _checkpoint_meta(config: PipelineConfig, layout: str, intervals, fingerprint) -> dict:
    # "torch-1" and the batch shape and layout: a checkpoint of the JAX
    # package (version 1, whose masks need not have this run's shape) is
    # cleared, never misread
    return dict(
        k=config.k,
        abundance=config.abundance,
        filter_bits=config.filter_bits,
        hash_functions=config.hash_functions,
        layout=layout,
        positions_per_row=config.positions_per_row,
        rows_per_batch=config.rows_per_batch,
        engine="bloom",
        intervals=[list(map(int, iv)) for iv in intervals],
        fingerprint=fingerprint,
        version="torch-1",
    )


def build_junctions_bloom(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    tmpdir: str | None = None,
    *,
    device="cuda",
    reference: bool = False,
) -> Enumerator:
    """Find the junctions of the input with the Bloom engine and write the
    junction list: the same bytes as the sort engine's.

    Arguments as sortpipe.build_junctions_sorted's; tmpdir holds spilled
    candidate masks (None: the system's temporary directory).
    """
    dev = resolve_device(device)
    ops = PLAIN if reference else KERNELS
    cfg = config.pass_config()  # raises the layout's capacity errors first
    k, P, B, w = cfg.k, cfg.P, cfg.B, cfg.w
    stats = RunStats()
    stats.timings.update(dict.fromkeys(PHASES, 0.0))
    t_start = time.time()

    sequences, batches, uploads = load_batches(input_paths, sequences, config, dev, stats)
    bases = [b.row0 * P for b in batches]
    log(
        f"Engine = bloom ({dev.type})\nVertex length = {k}\n"
        f"Hash functions = {cfg.q}\n"
        f"Filter size = {1 << cfg.f} ({cfg.layout} layout)\n"
        f"Capacity = {w} words\nPositions = {stats.total_positions}"
    )

    # ---- round split (reference InitialFilterFillerWorker analogue) ----
    if config.rounds > 1:
        t0 = time.time()
        if os.environ.get("TWOPACO_UNIFORM_SPLIT", "1") != "0":
            # near-uniform Buzhash values: a uniform split is as balanced
            # as a counted one, and rounds here only bound the filter
            # probes, so imbalance costs time, never correctness
            hist = np.ones(1 << BIN_POW, np.int64)
        else:
            hist = histogram.histogram_scan(uploads, k=k, P=P, fn=ops.histogram)
        intervals = _split_rounds(hist, config.rounds, BIN_POW)
        stats.timings["hist"] = time.time() - t0
        log(f"Splitting the input kmers set ({len(intervals)} rounds)... {intervals}")
    else:
        intervals = [(0, MASK32)]

    # ---- rounds: fill -> mark -> extract -> verify ----------------------
    fingerprint = (
        _input_fingerprint(input_paths, sequences) if checkpoint_dir is not None else None
    )
    ckpt = RoundCheckpoint(
        checkpoint_dir, _checkpoint_meta(config, cfg.layout, intervals, fingerprint)
    )
    junction_words: list[np.ndarray] = []
    masks = MaskStore(tmpdir, est_bytes=len(intervals) * len(batches) * B * P // 8)
    round_counts: list[list[int]] = []  # [round][batch] candidate counts
    for r, (low, high) in enumerate(intervals):
        restored = ckpt.load_round(r)
        if restored is not None:
            arrays, rstats = restored
            junction_words.append(arrays["junc_words"])
            masks.add_round(list(arrays["masks"]))
            round_counts.append([int(c) for c in arrays["counts"]])
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        log(f"Round {r}, {low}:{high}")

        t0 = time.time()
        filt = bloom.make_filter(cfg.f, cfg.layout, dev)
        for up in uploads:
            ops.fill(filt, *up, low, high, cfg=cfg)
        _sync(dev)
        t_fill = time.time() - t0

        t0 = time.time()
        marked = [ops.mark(filt, *up, low, high, cfg=cfg) for up in uploads]
        del filt
        # one fetch for every batch's count
        counts = [int(c) for c in torch.stack([c for _m, c in marked]).cpu()]
        t_mark = time.time() - t0

        t0 = time.time()
        n_cand = sum(counts)
        buf, state = extract.new_buffer(n_cand, w, dev)
        for (packed, nmask, _valid), (m, _c), base in zip(uploads, marked, bases):
            ops.extract(packed, nmask, m, buf, state, base, k=k, P=P)
        if state.tolist() != [n_cand, 0]:
            raise RuntimeError(f"candidate extraction {state.tolist()} != marks {n_cand}")
        t_extract = time.time() - t0

        # ---- exact verification: the sort engine's sort and judge -------
        t0 = time.time()
        if n_cand:
            verdict = ops.judge(*ops.sort(*buf, key_bits=2 * k), config.abundance)
            junc_words = verdict[0].cpu().numpy()
            n_groups, n_junc = verdict[3], verdict[4]
            del verdict
        else:
            junc_words = np.zeros((0, w), np.uint32)
            n_groups = n_junc = 0
        del buf
        _sync(dev)
        t_verify = time.time() - t0

        junction_words.append(junc_words)
        round_counts.append(counts)
        stats.rounds.append(dict(
            low=low, high=high, marks=n_cand, hash_table_size=n_groups,
            true_junctions=n_junc, false_positives=n_groups - n_junc,
            t_fill=t_fill, t_mark=t_mark, t_extract=t_extract, t_verify=t_verify,
        ))
        for key, val in (("fill", t_fill), ("mark", t_mark),
                         ("extract", t_extract), ("verify", t_verify)):
            stats.timings[key] += val
        log(
            f"Round {r} seconds: fill={t_fill:.4f} mark={t_mark:.4f} "
            f"extract={t_extract:.4f} verify={t_verify:.4f}\n"
            f"True junctions = {n_junc}\nFalse junctions = {n_groups - n_junc}\n"
            f"Hash table size = {n_groups}\nCandidate marks count = {n_cand}"
        )
        round_masks = [m for m, _c in marked]
        if ckpt.dir is not None:
            ckpt.save_round(
                r, stats.rounds[-1], junc_words=junc_words,
                masks=torch.stack(round_masks).cpu().numpy(),
                counts=np.asarray(counts, np.int64),
            )
        masks.add_round(round_masks)
        del marked, round_masks

    # ---- junction dictionary -----------------------------------------
    t0 = time.time()
    table = np.concatenate(junction_words)
    if len(table):
        keys = dna.words_to_bytes_keys(table)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        uniq = np.ones(len(keys), bool)
        uniq[1:] = keys[1:] != keys[:-1]
        table = np.ascontiguousarray(table[order][uniq])
    stats.distinct_junctions = len(table)
    stats.timings["dict"] = time.time() - t0
    log(f"Reallocating bifurcations time: {stats.timings['dict']:.1f}")
    enum = Enumerator(table, k, stats)

    # ---- pass 4: ids of the candidate positions, ordered output --------
    if out_path is not None:
        t0 = time.time()
        table_d = torch.from_numpy(table).to(dev)
        found = []
        for bi, (up, base) in enumerate(zip(uploads, bases)):
            cap = max(1, sum(rc[bi] for rc in round_counts))  # >= its candidates
            pos, ids, cnt = ops.lookup(*up, masks.batch_mask(bi, dev), table_d, cap, k=k, P=P)
            found.append((pos, ids, cnt, cap, base))
        masks.cleanup()
        cnts = [int(c) for c in torch.stack([c for _p, _i, c, _cap, _b in found]).cpu()]
        if any(c > cap for c, (_p, _i, _c, cap, _b) in zip(cnts, found)):
            raise RuntimeError("pass 4 found more junction positions than candidates")
        occ_pos = torch.cat(
            [p[:c].to(torch.int64) + base for c, (p, _i, _c, _cap, base) in zip(cnts, found)]
        ).cpu().numpy()
        occ_ids = torch.cat([i[:c] for c, (_p, i, _c, _cap, _b) in zip(cnts, found)]).cpu().numpy()
        del found, table_d
        stats.timings["lookup"] = time.time() - t0
        t0 = time.time()
        occurrences, n_stubs = emit_junctions(
            out_path, batches, occ_pos, occ_ids, len(table), P, timings=stats.timings
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        log(f"True marks count: {occurrences}")
    masks.cleanup()
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
