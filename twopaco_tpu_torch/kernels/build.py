"""Build, load and count the port's CUDA kernels.

The sources in csrc/ are compiled by nvcc for sm_90a, one nvcc process
per source, all started together, and linked into one shared library
with a plain C interface, at first use, into kernels/build/ (the file
name carries a hash of the sources and flags, so an edited source is
rebuilt; nvcc's output, with ptxas's register and spill report, goes to
build.log beside it). ctypes binds it: pointers and the stream travel as
ctypes.c_void_p. There is no fallback: without nvcc, or when the build
fails, loading raises KernelBuildError.

Each wrapper calls `count_launch(name)` where it launches its kernel, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = (
    "records.cu", "sort.cu", "judge.cu", "partition.cu",
    "assemble.cu", "compact.cu", "histogram.cu", "bloom_fill.cu",
    "bloom_mark.cu", "bloom_extract.cu", "bloom_lookup.cu", "route.cu",
    "occ_pack.cu", "bloom_shard.cu", "upload.cu", "merge.cu", "emit.cu",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_CANDIDATES = ("$CUDA_HOME/bin/nvcc", "/usr/local/cuda/bin/nvcc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_SZ = ctypes.c_size_t
_LL = ctypes.c_longlong
_TABS = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    "tp_error_string": ([_I], ctypes.c_char_p),
    "tp_sort_scratch_bytes": ([_SZ, _I], _SZ),
    "tp_build_records": (
        [_P, _I, _LL] + [_P] * 4 + [_LL] * 4 + [_I, _I] + [_U32] * 6 + [_P] * 4, _I
    ),
    "tp_sort_records": ([_P] * 3 + [_SZ, _I, _I] + [_P] * 7 + [_SZ] + [_P] * 4, _I),
    "tp_judge_scratch_bytes": ([_SZ], _SZ),
    "tp_judge_compact": (
        [_P, _P, _P, _SZ, _I, _I, ctypes.c_ulonglong, _P, _SZ, _U32] + [_P] * 5, _I
    ),
    "tp_judge_records": (
        [_P, _P, _SZ, _I, _I, ctypes.c_ulonglong, _P, _SZ, _U32] + [_P] * 5, _I
    ),
    "tp_partition_max_parts": ([], _I),
    "tp_partition_tile": ([_I], _I),
    "tp_partition_records": (
        [_P, _I, _LL, _I, _I] + [_U32] * 6 + [_P, _I, _I, _P, _SZ, _U32] + [_P] * 5, _I
    ),
    "tp_assemble_round": ([_P] * 4 + [_I] * 5 + [_SZ] + [_P] * 4, _I),
    "tp_compact_tile": ([], _I),
    "tp_compact_append": ([_P] * 3 + [_SZ, _I] + [_P] * 3 + [_LL] + [_P] * 2 + [_SZ, _U32, _P], _I),
    "tp_histogram_batches": ([_P, _I, _LL, _I, _I, _I] + [_U32] * 4 + [_P] * 2, _I),
    "tp_route_max_shards": ([], _I),
    "tp_route_tile": ([], _I),
    "tp_route_records": (
        [_P] * 3 + [_SZ, _I, _I, _P, _I, _P, _SZ, _U32] + [_P] * 5, _I
    ),
    "tp_sort_occurrences": ([_P, _P, _SZ, _I, _LL] + [_P] * 3 + [_SZ, _P, _P], _I),
    "tp_upload_rows": ([_P, _LL, _P, _LL, _I, _P, _P, _P], _I),
    "tp_merge_rows": ([_P, _LL, _I, _P, _I, _I, _I] + [_P] * 4 + [_LL] + [_P] * 3, _I),
    "tp_merge_keys": ([_P, _LL, _P, _I, _P, _LL, _I, _I, _I] + [_P] * 3 + [_LL, _P, _P], _I),
    "tp_emit_check": ([_P, _LL, _I, _LL, _I, _P, _LL, _P, _LL] + [_P] * 3 + [_LL] + [_P] * 3,
                      _I),
    "tp_emit_chunk": ([_P] + [_LL] * 4 + [_P] * 3 + [_LL, _I, _I, _P, _P], _I),
    "tp_bloom_fill": ([_P, _I, _LL] + [_I] * 2 + [_U32] * 2 + [_TABS] + [_I] * 3 + [_P] * 2, _I),
    "tp_bloom_mark": ([_P, _I, _LL] + [_I] * 2 + [_U32] * 2 + [_TABS] + [_I] * 3 + [_P] * 4, _I),
    "tp_bloom_run": ([_LL, _I], _I),
    "tp_extract_tile": ([], _I),
    "tp_bloom_extract": (
        [_P, _P, _I, _LL, _I, _I] + [_P] * 4 + [_LL, _P, _P, _SZ, _U32, _P], _I
    ),
    "tp_lookup_tile": ([], _I),
    "tp_bloom_lookup": (
        [_P, _P, _I, _LL, _I, _I, _P, _P, _LL, _LL, _I] + [_P] * 3 + [_SZ, _U32, _P], _I
    ),
    "tp_shard_scratch_bytes": ([_SZ, _I, _I, _I, _I], _SZ),
    "tp_shard_bucket": (
        [_P] * 3 + [_I] * 5 + [_U32] * 2 + [_TABS] + [_I] * 5 + [_P, _SZ, _U32] + [_P] * 4,
        _I,
    ),
    "tp_shard_fill_apply": ([_P, _SZ, _SZ, _I, _P, _P], _I),
    "tp_shard_probe": ([_P, _SZ, _SZ, _I, _P, _P, _P], _I),
    "tp_shard_mark_finish": (
        [_P] * 5 + [_I] * 5 + [_U32] * 2 + [_TABS, _I] + [_P] * 3, _I
    ),
}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc(candidates=NVCC_CANDIDATES) -> str:
    """nvcc from PATH, else the first existing candidate path."""
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in candidates:
        path = os.path.expandvars(cand)
        if "$" not in path and os.access(path, os.X_OK):
            return path
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from csrc/ at first use and there is no "
        "fallback to the plain PyTorch versions for CUDA tensors"
    )


class KernelLibrary:
    """The compiled kernel library, built and loaded on first `get()`."""

    def __init__(self, build_dir: Path = BUILD_DIR, candidates=NVCC_CANDIDATES):
        self.build_dir = Path(build_dir)
        self.candidates = candidates
        self.build_seconds: float | None = None  # None: not built here
        self.build_log = ""
        self._lib = None

    def _source_hash(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in sorted(os.listdir(CSRC)):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
        return h.hexdigest()[:16]

    def _build(self, target: Path) -> None:
        nvcc = find_nvcc(self.candidates)
        self.build_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        with tempfile.TemporaryDirectory(dir=self.build_dir) as tmp:
            objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for s, o in zip(SOURCES, objs)
            ]
            logs = [f"== {s}\n{p.communicate()[0]}" for s, p in zip(SOURCES, procs)]
            failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
            if not failed:
                lib_tmp = os.path.join(tmp, "lib.so")
                link = subprocess.run(
                    [nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, *objs],
                    capture_output=True, text=True,
                )
                logs.append(f"== link\n{link.stdout}{link.stderr}")
                if link.returncode != 0:
                    failed = ["link"]
                else:
                    os.replace(lib_tmp, target)
        self.build_seconds = time.time() - t0
        self.build_log = "".join(logs)
        (self.build_dir / "build.log").write_text(self.build_log)
        if failed:
            raise KernelBuildError(
                f"nvcc failed ({', '.join(failed)}):\n{self.build_log[-4000:]}"
            )

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            target = self.build_dir / f"libtwopaco_kernels-{self._source_hash()}.so"
            if not target.exists():
                self._build(target)
            lib = ctypes.CDLL(str(target))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            self._lib = lib
        return self._lib


LIBRARY = KernelLibrary()
_LAUNCHES: Counter = Counter()
# the look-back scratch of each (device, stream, name): "bucket", shared by
# route.cu and bloom_shard.cu's bucketing, "judge" (judge.cu), "partition"
# (partition.cu), "compact" (compact.cu), "lookup" (bloom_lookup.cu) and
# "extract" (bloom_extract.cu):
# [uint8 tensor, epoch counter]
_LOOKBACK: dict = {}
_EPOCHS = (1 << 30) - 1


def lib() -> ctypes.CDLL:
    return LIBRARY.get()


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().tp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def hash_tables(tables) -> ctypes.Array:
    """The four Buzhash char tables as the 16 u32 a Bloom kernel takes."""
    return (ctypes.c_uint32 * 16)(*(v for t in tables for v in t))


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def lookback_scratch(device: torch.device, need: int,
                     name: str = "bucket") -> tuple[torch.Tensor, int]:
    """(scratch, epoch) for one call of a look-back kernel on the current
    stream: a zeroed uint8 tensor of at least need bytes kept across calls
    (a tile counter, then the look-back's status words), and the call's
    epoch in [1, 2^30 - 1], another than the call before's. Each call tags
    its status words with its epoch and its last kernel resets the
    counter, so no call clears the scratch. Kernels whose scratch holds
    more than status words (the judge's segments) take a name of their
    own, so that no status word is read where another kernel kept data."""
    key = (device.index, stream_ptr(), name)
    ent = _LOOKBACK.get(key)
    if ent is None or ent[0].numel() < need:
        ent = _LOOKBACK[key] = [torch.zeros(need, dtype=torch.uint8, device=device),
                                itertools.count()]
    return ent[0], next(ent[1]) % _EPOCHS + 1


def drop_lookback_scratch(device: torch.device, name: str = "bucket") -> None:
    """Forget the current stream's scratch after a failed call: its tile
    counter may not have been reset."""
    _LOOKBACK.pop((device.index, stream_ptr(), name), None)


_TABLE_COLS = 7  # int64 a row of batch_table


def batch_table(uploads, offsets=None, tail=None):
    """The device table of a kernel call over batches (common.cuh TpBatch):
    a row of 7 int64 a (packed, nmask, valid) batch (its three pointers,
    valid's 0 when it is None, for a kernel that reads none; rows, RW, NW,
    and its offset, e.g. of its mask in the Bloom mark's output; 0 where
    none is given), copied from pinned memory so that the copy needs no
    wait for the stream's earlier work. With tail (int64
    values, e.g. the lookup's batch bases) they follow the rows in the same
    copy, and the result is (table, the tail's view)."""
    offsets = offsets or [0] * len(uploads)
    flat = [x for (p, m, v), off in zip(uploads, offsets)
            for x in (p.data_ptr(), m.data_ptr(), 0 if v is None else v.data_ptr(),
                      p.shape[0], p.shape[1], m.shape[1], off)]
    table = torch.tensor(flat + list(tail or ()), dtype=torch.int64).pin_memory().to(
        uploads[0][0].device, non_blocking=True)
    return table if tail is None else (table, table[_TABLE_COLS * len(uploads):])


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path), False when
    all lie on one CUDA device (the kernel path); raises otherwise."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        # the kernels launch on the current device's current stream
        index = next(iter(devices)).index
        if index is not None and index != torch.cuda.current_device():
            raise ValueError(
                f"tensors on cuda:{index}, current device is "
                f"cuda:{torch.cuda.current_device()}: launch under "
                "torch.cuda.device(...)"
            )
        return False
    raise ValueError(
        f"tensors must all lie on the CPU or on one CUDA device: {devices}"
    )


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
