"""twopaco_tpu_torch — the PyTorch + CUDA port of twopaco-tpu.

Junction enumeration for compacted de Bruijn graphs (TwoPaCo's `.dbg`
12-byte junction list) with the sort-join engine: host numpy reads and
batches the genomes, three hand-written CUDA kernels (record build,
radix sort, judge + compact) do the device work, and a numpy tail merges
and writes the junction list. Every kernel has a plain PyTorch version
beside it; a wrapper runs that version only for CPU tensors.

Importing this package imports neither JAX nor `twopaco_tpu`. It keeps
large freed host allocations in the process heap (_retain_heap;
TWOPACO_RETAIN_HEAP=0 turns that off).
"""

import os as _os


def _retain_heap() -> None:
    """Keep freed large allocations in the process heap.

    glibc serves >128KB allocations via mmap and returns them to the OS
    on free; on VMs whose memory is demand-faulted from the hypervisor
    (first touch of a new page measured at ~70-100us on the JAX
    package's TPU host), that makes every large numpy temporary re-fault
    its pages — array passes ran 30-50x slower than warm-memory reruns. Raising the mmap/trim
    thresholds makes the heap retain and reuse warmed pages; RSS stays
    high, which is the intended trade. TWOPACO_RETAIN_HEAP=0 disables.
    """
    if _os.environ.get("TWOPACO_RETAIN_HEAP", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        # INT_MAX: even ~1-2 GB occurrence-stream temporaries (62-strain
        # pangenomes hit 40%+ junction-occurrence density) must come
        # from the retained heap, not fresh cold-faulted mmaps
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except Exception:
        pass  # non-glibc platforms: default allocator behavior


_retain_heap()

__version__ = "0.1.0"
