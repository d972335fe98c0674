"""The builds' output sink: a FIFO whose reader, a thread of the harness,
drains what the program writes, so that no build's .dbg goes to disk.
The checked build's output is kept in memory; every later build's is
compared with it byte for byte as it arrives (libc memcmp, which runs
without the interpreter lock: a sha256 of the 1.5 GB output would hold
back the program's emit, which waits on the FIFO)."""

from __future__ import annotations

import ctypes
import errno
import fcntl
import os
import threading
import time

import numpy as np

F_SETPIPE_SZ = 1031  # linux/fcntl.h
PIPE_SIZES = (16 << 20, 4 << 20, 1 << 20)  # tried in turn: root may pass pipe-max-size
READ_BYTES = 4 << 20
_memcmp = ctypes.CDLL(None).memcmp
_memcmp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
_memcmp.restype = ctypes.c_int


class Drain:
    """One build's reader of the FIFO at `path`: start() before the
    build, finish() after it; then `size`, `data` (the bytes, when
    keep=True) and `same` (with expect: whether the output equals those
    bytes)."""

    def __init__(self, path: str, keep: bool = False, expect: bytes | None = None):
        self.path = path
        self.keep = keep
        self.expect = None if expect is None else np.frombuffer(expect, dtype=np.uint8)
        self.same = None
        self.size = 0
        self.data = None
        self.pipe_bytes = None
        self.error = None
        self._opened = threading.Event()
        self._thread = threading.Thread(target=self._run, name="gpubench-drain", daemon=True)

    def start(self) -> "Drain":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            fd = os.open(self.path, os.O_RDONLY)  # waits for the writer
        except OSError as e:
            self.error = e
            return
        self._opened.set()
        try:
            for size in PIPE_SIZES:
                try:
                    self.pipe_bytes = fcntl.fcntl(fd, F_SETPIPE_SZ, size)
                    break
                except OSError:
                    continue
            chunks = []
            buf = np.empty(READ_BYTES, dtype=np.uint8)
            same = True
            while True:
                n = os.readv(fd, [buf])
                if n == 0:
                    break
                if self.expect is not None and same:
                    end = self.size + n
                    same = end <= len(self.expect) and _memcmp(
                        buf.ctypes.data, self.expect.ctypes.data + self.size, n) == 0
                self.size += n
                if self.keep:
                    chunks.append(buf[:n].tobytes())
            if self.expect is not None:
                self.same = same and self.size == len(self.expect)
            if self.keep:
                self.data = b"".join(chunks)
        except OSError as e:
            self.error = e
        finally:
            os.close(fd)

    def finish(self, timeout: float = 600.0) -> None:
        """Wait for the drain to reach the end of the output. A build that
        never opened its output leaves the reader waiting for a writer:
        open the FIFO once for writing, which ends it with no bytes."""
        t_end = time.monotonic() + timeout
        while self._thread.is_alive() and not self._opened.is_set():
            try:
                os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
                break
            except OSError as e:  # ENXIO: the reader is not in open() yet
                if e.errno != errno.ENXIO or time.monotonic() > t_end:
                    raise
                time.sleep(0.001)
        self._thread.join(max(0.0, t_end - time.monotonic()))
        if self._thread.is_alive():
            raise RuntimeError(f"the drain of {self.path} did not end in {timeout} s")
        if self.error is not None:
            raise self.error


def make_fifo(directory: str, name: str = "sink.dbg") -> str:
    path = os.path.join(directory, name)
    os.mkfifo(path, 0o600)
    return path
