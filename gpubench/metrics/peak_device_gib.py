"""peak_device_gib: torch.cuda.max_memory_allocated() over the window's
builds (reset at the window's start) on the fullest of the cell's cards,
in GiB."""


def read(record):
    peak = record["window_peak_bytes"]
    return peak / 2**30 if peak else None
