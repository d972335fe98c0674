"""read_s: seconds a build spends reading the FASTA (io/fasta.py,
io/native.py): the CLI's `time read`, averaged over the traced builds."""

from gpubench.readers import phase_seconds


def read(record):
    return phase_seconds(record, ("read",))
