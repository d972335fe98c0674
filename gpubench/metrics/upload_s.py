"""upload_s: seconds a build spends cutting the window rows and packing
them on the card (io/windows.py, passes/upload.py): the CLI's `time
windows` + `upload`, averaged over the traced builds."""

from gpubench.readers import phase_seconds


def read(record):
    return phase_seconds(record, ("windows", "upload"))
