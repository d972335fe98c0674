"""The benchmark of twopaco_tpu_torch on one NVIDIA H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the benchmark measures with lives here: the input generator
(genome.py), the plain reference (reference.py) and its control
(control.py), the FIFO sink of the builds' output (sink.py), the reading
of the profiler's trace (devtrace.py), the table of peaks and the byte
counts of the round sort (peaks.py). The cells are data: BENCHMARK.json
at the repository root names them, each configuration's sizes are
configs/<file>.json, each traffic mix's CLI flags traffic/<name>.json, and
each metric is one reader, metrics/<name>.py (harness.py says what a
reader gets). Nothing here imports jax or twopaco_tpu.
"""
