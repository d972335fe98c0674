"""Build, load and count the port's CUDA kernels.

The sources in csrc/ are compiled by nvcc for sm_90a into one shared
library with a plain C interface, at first use, into kernels/build/ (the
file name carries a hash of the sources and flags, so an edited source
is rebuilt; nvcc's output, with ptxas's register and spill report, goes
to build.log beside it). ctypes binds it: pointers and the stream travel as
ctypes.c_void_p. There is no fallback: without nvcc, or when the build
fails, loading raises KernelBuildError.

Each wrapper calls `count_launch(name)` where it launches its kernel, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
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
SOURCES = ("scan.cu", "records.cu", "sort.cu", "judge.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_CANDIDATES = ("$CUDA_HOME/bin/nvcc", "/usr/local/cuda/bin/nvcc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_SZ = ctypes.c_size_t
_SIGNATURES = {
    "tp_error_string": ([_I], ctypes.c_char_p),
    "tp_scan_scratch_words": ([_SZ], _SZ),
    "tp_sort_count_words": ([_SZ], _SZ),
    "tp_build_records": (
        [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _U32, _U32,
         _U32, _U32, _U32, _U32, _P, _P, _P, _P],
        _I,
    ),
    "tp_sort_records": ([_P, _P, _P, _SZ, _I] + [_P] * 11, _I),
    "tp_judge_compact": (
        [_P, _P, _P, _SZ, _I, _I, ctypes.c_ulonglong] + [_P] * 7, _I
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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.time() - t0
        self.build_log = proc.stdout + proc.stderr
        (self.build_dir / "build.log").write_text(self.build_log)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{self.build_log[-4000:]}"
            )
        os.replace(tmp, target)

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


def lib() -> ctypes.CDLL:
    return LIBRARY.get()


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().tp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


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
