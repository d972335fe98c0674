"""emit_assemble_s: seconds the emit's writer spends assembling the
12-byte records of decoded chunks (io/junctions.py ChunkWriter.write
outside its file writes: the `emit_write` span's assemble_s counter),
averaged over the traced builds."""

from gpubench.spans import counter_reader

read = counter_reader("emit_write", "assemble_s")
