"""The device functions every engine calls, in one table: the kernels'
wrappers (KERNELS) or their plain PyTorch versions (PLAIN).

An engine picks one table once (reference=True: PLAIN) and hands it down
to the steps it calls; no other module chooses between a kernel and its
plain version. A wrapper in KERNELS runs its plain version itself for CPU
tensors (kernels/build.py on_cpu), so KERNELS serves the CPU too, and
PLAIN runs the plain versions on a card to check the kernels there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from twopaco_tpu_torch.passes import (
    emit, extract, fill, histogram, judge, lookup, mark, merge, occ, partition, records, route,
    shardbloom, sort, stream, upload,
)


@dataclass(frozen=True)
class Ops:
    """The device functions of the sort, Bloom and dist engines."""

    # the front end and the records (every engine)
    pack: Callable
    build: Callable
    build_batches: Callable
    histogram: Callable
    sort: Callable
    judge: Callable
    # the sort engine's rounds, the occurrence keys, the merge and the emit
    partition: Callable
    assemble: Callable
    compact: Callable
    occ: Callable
    merge: Callable
    check: Callable
    chunk: Callable
    # the Bloom engine
    fill: Callable
    mark: Callable
    extract: Callable
    lookup: Callable
    # the dist engine and its Bloom gate
    route: Callable
    judge_records: Callable
    word0: Callable
    bucket_fill: Callable
    bucket_mark: Callable
    fill_local: Callable
    probe_local: Callable
    mark_finish: Callable


KERNELS = Ops(
    pack=upload.pack_rows, build=records.build_sort_records,
    build_batches=records.build_sort_records_batches,
    histogram=histogram.histogram_vertex_hashes_batches, sort=sort.sort_records,
    judge=judge.judge_compact,
    partition=partition.partition_scan, assemble=partition.assemble_round,
    compact=stream.compact_append, occ=occ.sort_occurrences, merge=merge.merge_packed,
    check=emit.check, chunk=emit.chunk,
    fill=fill.bloom_fill_batches, mark=mark.bloom_mark_batches,
    extract=extract.extract_records_batches, lookup=lookup.pass4_lookup_batches,
    route=route.route_records, judge_records=judge.judge_records,
    word0=histogram.word0_histogram_batches, bucket_fill=shardbloom.bucket_fill,
    bucket_mark=shardbloom.bucket_mark, fill_local=shardbloom.fill_local,
    probe_local=shardbloom.probe_local, mark_finish=shardbloom.mark_finish,
)
PLAIN = Ops(
    pack=upload.pack_rows_plain, build=records.build_sort_records_plain,
    build_batches=records.build_sort_records_batches_plain,
    histogram=histogram.histogram_vertex_hashes_batches_plain, sort=sort.sort_records_plain,
    judge=judge.judge_compact_plain,
    partition=partition.partition_scan_plain, assemble=partition.assemble_round_plain,
    compact=stream.compact_append_plain, occ=occ.sort_occurrences_plain,
    merge=merge.merge_packed_plain, check=emit.check_plain, chunk=emit.chunk_plain,
    fill=fill.bloom_fill_batches_plain, mark=mark.bloom_mark_batches_plain,
    extract=extract.extract_records_batches_plain,
    lookup=lookup.pass4_lookup_batches_plain,
    route=route.route_records_plain, judge_records=judge.judge_records_plain,
    word0=histogram.word0_histogram_batches_plain, bucket_fill=shardbloom.bucket_fill_plain,
    bucket_mark=shardbloom.bucket_mark_plain, fill_local=shardbloom.fill_local_plain,
    probe_local=shardbloom.probe_local_plain, mark_finish=shardbloom.mark_finish_plain,
)
