"""emit_s: seconds a build spends writing the junction list
(passes/pipeline.py emit_junctions_packed, io/junctions.py ChunkWriter):
the CLI's `time emit`, averaged over the traced builds."""

from gpubench.readers import phase_seconds


def read(record):
    return phase_seconds(record, ("emit",))
