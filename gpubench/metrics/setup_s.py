"""setup_s: seconds from the start of the harness's run (before torch is
imported) to the window's start: the import, the input's generation, the
warm-up (the kernel and host libraries, built in the checkout on a
checkout's first run) and the checked build."""


def read(record):
    return record["setup_s"]
