"""Bloom junction engine on one device (`--tpu-engine bloom`).

The port of twopaco_tpu/passes/pipeline.py:639-924, the reference
TwoPaCo's own algorithm (vertexenumerator.h:122-466):

  1. read, window rows and upload, as the sort engine does them
     (sortpipe.load_batches: the rows packed on the device);
  2. device, per round (a vertex-hash interval, the reference's -r):
     fill   a 2^f-slot Bloom filter with the canonical edges of every
            position in the round (passes/fill.py);
     mark   the candidate positions: a vertex with more than one in- or
            out-extension in the filter (passes/mark.py), kept for pass 4;
     extract the candidates' records into the round's buffer, in one
            call (passes/extract.py);
     verify them exactly: the sort engine's sort and judge
            (passes/sort.py, passes/judge.py), whose junction table is
            the round's junctions;
  3. host: the rounds' junctions into one sorted dictionary;
  4. device, in one call over the run's batches (a group of batches a call
     when the masks spilled): the candidate positions found in the
     dictionary as position-sorted u64 occurrence keys (passes/lookup.py),
     which stay where they are: checked and written with stubs there by
     the emit of every packed merge (passes/emit.py check_keys,
     write_keys). Where the ids with the stubs' do not fit the sort
     engine's key layout (sortpipe._packed_merge), the keys are fetched,
     decoded and written by pipeline.emit_junctions.

TWOPACO_UNIFORM_SPLIT=0 splits the hash space by a measured histogram
(passes/histogram.py) instead of uniformly; TWOPACO_MASK_SPILL_BYTES
(default 1 GiB) bounds the candidate masks kept between pass 2 and pass
4, above which each round's masks go to a file in tmpdir.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Sequence

import numpy as np
import torch

from twopaco_tpu_torch import dna, trace
from twopaco_tpu_torch.ops import bloom
from twopaco_tpu_torch.ops.pack import MASK32
from twopaco_tpu_torch.passes import emit, extract, histogram
from twopaco_tpu_torch.passes.histogram import BIN_POW
from twopaco_tpu_torch.passes.pipeline import (
    Enumerator,
    PipelineConfig,
    RoundCheckpoint,
    RunStats,
    _input_fingerprint,
    _split_rounds,
    emit_junctions,
    timed_engine,
)
from twopaco_tpu_torch.passes.occ import OccKeys
from twopaco_tpu_torch.passes.sortpipe import (
    _free_bytes,
    _gib,
    _packed_merge,
    _sync,
    load_batches,
    merge_pos_bits,
    resolve_device,
    wide_layout,
)
from twopaco_tpu_torch.passes.versions import KERNELS, PLAIN

# the phase times every run reports, summed over rounds
PHASES = (
    "read", "windows", "upload", "hist", "fill", "mark", "extract", "verify",
    "dict", "lookup", "emit",
)


# positions a lookup call may hold (its ranks and ids are int32)
LOOKUP_POSITIONS = (1 << 31) - 1


class MaskStore:
    """Each round's packed candidate masks, kept for pass 4 (twopaco_tpu
    pipeline.py:291 _MaskStore; the reference's candidate_<round>.tmp
    files, vertexenumerator.h:485-490). Up to TWOPACO_MASK_SPILL_BYTES of
    masks in the run (default 1 GiB) they stay where they are, on the
    device; above it each round's are written once to a .npy file in a
    fresh directory under tmpdir and read back memory-mapped, a group of
    batches at a time."""

    def __init__(self, tmpdir: str | None, est_bytes: int):
        self.budget = int(os.environ.get("TWOPACO_MASK_SPILL_BYTES", str(1 << 30)))
        self.dir = (
            tempfile.mkdtemp(prefix="twopaco_masks_", dir=tmpdir)
            if est_bytes > self.budget else None
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

    def group_size(self, batch_bytes: int) -> int:
        """Batches a pass-4 group holds: all of them while the masks stay
        on the device; when spilled, as many as TWOPACO_MASK_SPILL_BYTES of
        one group's masks (at least one)."""
        return 1 << 62 if self.dir is None else max(1, self.budget // max(batch_bytes, 1))

    def group_masks(self, first: int, stop: int, device) -> list:
        """The OR of every round's mask of batches first .. stop-1, on
        device: per batch a (B, P/8) uint8 tensor. One round kept on the
        device: its own masks; else each round's group stacked, moved to
        the device once and ORed into the first."""
        if self._views is None:
            self._views = [
                np.load(e, mmap_mode="r") if isinstance(e, str) else e for e in self._rounds
            ]
        group = [rm[first:stop] for rm in self._views]
        if len(group) == 1 and all(isinstance(m, torch.Tensor) for m in group[0]):
            return list(group[0])  # the mark's outputs, on the device
        out = None
        for part in group:
            if isinstance(part, np.ndarray):  # a spilled round's rows
                t = torch.from_numpy(np.array(part))
            elif isinstance(part[0], np.ndarray):  # a round restored from a checkpoint
                t = torch.from_numpy(np.stack(part))
            else:
                t = torch.stack(list(part))
            t = t.to(device)
            out = t if out is None else out.bitwise_or_(t)
        return list(out)

    def cleanup(self) -> None:
        self._rounds = []
        self._views = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


def key_layout(n_slots: int, n_sequences: int, n_table: int, wide: bool) -> tuple[int, bool]:
    """-> (id_bits of pass 4's occurrence keys, whether they take the
    keyed emit). The sort engine's layout (sortpipe.merge_pos_bits) where
    its packed merge would take the ids with the stubs'; else positions
    below n_slots in as few high bits as they need, the emit then
    pipeline.emit_junctions."""
    id_bits = 64 - merge_pos_bits(n_slots, wide)
    if _packed_merge(n_table, n_sequences, id_bits):
        return id_bits, True
    return min(62, 64 - max(1, (n_slots - 1).bit_length())), False


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


@timed_engine(PHASES)
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

    sequences, batches, uploads = load_batches(input_paths, sequences, config, dev, stats,
                                               ops=ops)
    bases = [b.row0 * P for b in batches]
    log(
        f"Engine = bloom ({dev.type})\nVertex length = {k}\n"
        f"Hash functions = {cfg.q}\n"
        f"Filter size = {1 << cfg.f} ({cfg.layout} layout)\n"
        f"Capacity = {w} words\nPositions = {stats.total_positions}"
    )

    # ---- round split (reference InitialFilterFillerWorker analogue) ----
    if config.rounds > 1:
        with trace.span("hist"):
            if os.environ.get("TWOPACO_UNIFORM_SPLIT", "1") != "0":
                # near-uniform Buzhash values: a uniform split is as balanced
                # as a counted one, and rounds here only bound the filter
                # probes, so imbalance costs time, never correctness
                hist = np.ones(1 << BIN_POW, np.int64)
            else:
                hist = histogram.histogram_scan(uploads, k=k, P=P, fn=ops.histogram)
            intervals = _split_rounds(hist, config.rounds, BIN_POW)
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
        with trace.span("round", r=r, low=low, high=high) as rspan:
            with trace.span("fill"):
                filt = bloom.make_filter(cfg.f, cfg.layout, dev)
                ops.fill(filt, uploads, low, high, cfg=cfg)  # one launch a round
                _sync(dev)

            with trace.span("mark"):
                # one launch
                round_masks, counts_d = ops.mark(filt, uploads, low, high, cfg=cfg)
                del filt
                counts = [int(c) for c in counts_d.cpu()]  # one fetch for every batch's count

            with trace.span("extract"):
                n_cand = sum(counts)
                buf, state = extract.new_buffer(n_cand, w, dev)
                ops.extract(uploads, round_masks, buf, state, bases, k=k, P=P)  # one call
                if state.tolist() != [n_cand, 0]:
                    raise RuntimeError(f"candidate extraction {state.tolist()} != marks {n_cand}")

            # ---- exact verification: the sort engine's sort and judge -------
            with trace.span("verify"):
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

            junction_words.append(junc_words)
            round_counts.append(counts)
            t = trace.totals(rspan)
            t_fill, t_mark, t_extract, t_verify = (
                t.get(key, 0.0) for key in ("fill", "mark", "extract", "verify"))
            stats.rounds.append(dict(
                low=low, high=high, marks=n_cand, hash_table_size=n_groups,
                true_junctions=n_junc, false_positives=n_groups - n_junc,
                t_fill=t_fill, t_mark=t_mark, t_extract=t_extract, t_verify=t_verify,
            ))
            log(
                f"Round {r} seconds: fill={t_fill:.4f} mark={t_mark:.4f} "
                f"extract={t_extract:.4f} verify={t_verify:.4f}\n"
                f"True junctions = {n_junc}\nFalse junctions = {n_groups - n_junc}\n"
                f"Hash table size = {n_groups}\nCandidate marks count = {n_cand}"
            )
            if ckpt.dir is not None:
                with trace.span("checkpoint"):
                    ckpt.save_round(
                        r, stats.rounds[-1], junc_words=junc_words,
                        masks=torch.stack(round_masks).cpu().numpy(),
                        counts=np.asarray(counts, np.int64),
                    )
            masks.add_round(round_masks)
            del round_masks, counts_d

    # ---- junction dictionary -----------------------------------------
    with trace.span("dict") as dspan:
        table = np.concatenate(junction_words)
        if len(table):
            keys = dna.words_to_bytes_keys(table)
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            uniq = np.ones(len(keys), bool)
            uniq[1:] = keys[1:] != keys[:-1]
            table = np.ascontiguousarray(table[order][uniq])
    stats.distinct_junctions = len(table)
    log(f"Reallocating bifurcations time: {dspan.seconds:.1f}")
    enum = Enumerator(table, k, stats)

    # ---- pass 4: the candidate positions' keys, the junction list --------
    if out_path is not None:
        n_slots = len(batches) * B * P
        id_bits, keyed = key_layout(n_slots, len(sequences), len(table),
                                    wide_layout(config, n_slots))
        with trace.span("lookup"):
            table_d = torch.from_numpy(table).to(dev)
            # one call over the run's batches; groups of batches when the masks
            # spilled or the positions pass a call's int32 ranks
            per = min(masks.group_size(B * P // 8), max(1, LOOKUP_POSITIONS // (B * P)))
            found = []
            for g0 in range(0, len(batches), per):
                g1 = min(g0 + per, len(batches))
                cap = max(1, sum(sum(rc[g0:g1]) for rc in round_counts))  # >= its candidates
                found.append((*ops.lookup(uploads[g0:g1], masks.group_masks(g0, g1, dev),
                                          table_d, cap, bases[g0:g1], k=k, P=P,
                                          id_bits=id_bits), cap))
            masks.cleanup()
            del table_d
            cnts = [int(c) for c in torch.stack([c for _k, c, _cap in found]).cpu()]
            if any(c > cap for c, (*_r, cap) in zip(cnts, found)):
                raise RuntimeError("pass 4 found more junction positions than candidates")
            # the groups' keys in batch order: ascending
            parts = [keys[:c] for c, (keys, _c, _cap) in zip(cnts, found)]
            keys = torch.cat(parts) if len(parts) > 1 else parts[0]
            del found, parts
            if keyed:
                free = _free_bytes(dev)
                chunk_occ = emit.chunk_size(batches, free)
                if chunk_occ < min(emit.CHUNK, keys.numel()):
                    log(f"Emit in chunks of {chunk_occ} occurrences: {_gib(free)} is free")
                checked = emit.check_keys(keys, batches, len(table), P, id_bits,
                                          chunk_occ=chunk_occ, fn=ops.check)
            else:
                occ_pos, occ_ids = OccKeys(keys, id_bits).decode()
                del keys
        with trace.span("emit"):
            if keyed:
                occurrences, n_stubs = emit.write_keys(out_path, batches, keys, checked,
                                                       len(table), P, id_bits, fn=ops.chunk)
            else:
                occurrences, n_stubs = emit_junctions(out_path, batches, occ_pos, occ_ids,
                                                      len(table), P)
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        log(f"True marks count: {occurrences}")
    masks.cleanup()
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
