"""emit_decode_wait_s: seconds the emit's writer waits for the decode
thread's next chunk (passes/pipeline.py _write_spliced: the `emit_write`
span's decode_wait_s counter), averaged over the traced builds."""

from gpubench.spans import counter_reader

read = counter_reader("emit_write", "decode_wait_s")
