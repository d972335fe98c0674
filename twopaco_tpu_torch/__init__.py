"""twopaco_tpu_torch — the PyTorch + CUDA port of twopaco-tpu.

Junction enumeration for compacted de Bruijn graphs (TwoPaCo's `.dbg`
12-byte junction list) with the sort-join engine: host numpy reads and
batches the genomes, three hand-written CUDA kernels (record build,
radix sort, judge + compact) do the device work, and a numpy tail merges
and writes the junction list. Every kernel has a plain PyTorch version
beside it; a wrapper runs that version only for CPU tensors.

Importing this package imports neither JAX nor `twopaco_tpu`.
"""

__version__ = "0.1.0"
