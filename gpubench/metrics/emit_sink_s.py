"""emit_sink_s: seconds the emit's writer spends in the output file's
writes and close (io/junctions.py ChunkWriter: the `emit_write` span's
sink_s counter; the benchmark's sink is a FIFO a harness thread drains),
averaged over the traced builds."""

from gpubench.spans import counter_reader

read = counter_reader("emit_write", "sink_s")
