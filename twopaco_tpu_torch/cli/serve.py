"""twopaco server mode of the port: a resident daemon that runs CLI
requests warm.

    python -m twopaco_tpu_torch.cli.serve [--device cuda|cpu] [--socket PATH]
        [--idle-timeout S]

Why: a cold CLI process pays the interpreter, the torch import, the CUDA
context and the kernel library's load before any work happens. The
daemon pays them once (warm()) and serves requests from a thin client
(native/tpclient.c, built by client_path(); it spawns the daemon when
the socket is absent) or any client of the wire format below, which is
the JAX package's server's byte for byte.

Protocol (length-prefixed, binary-safe):
  request:  u32le n + n bytes JSON {"tool": "twopaco"|"graphdump"|
            "naive"|"__shutdown__", "argv": [...], "cwd": "..."}
  response: frames of tag byte 'O' (stdout) / 'E' (stderr) + u32le n +
            n bytes, terminated by tag 'X' + u32le exit-code.

One request runs at a time. A request picks its device through its own
argv, as the CLI does; --device is the one the daemon warms (cuda, the
default, exits non-zero without a card and never serves on the CPU).
After each request the daemon synchronises the card and returns its
cached blocks, so that the next request's round plan sees the free memory
a cold process would. Defaults from the environment: TWOPACO_SERVER_SOCKET,
TWOPACO_SERVER_IDLE_S, TWOPACO_SERVER_DEVICE (a daemon that the client
spawns takes no flags).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import traceback

DEFAULT_SOCKET = os.environ.get("TWOPACO_SERVER_SOCKET", "/tmp/twopaco_tpu_torch.sock")


def client_path():
    """The port's tpclient (native/tpclient.c), built with cc -O2 at the
    first call into native/build/."""
    from twopaco_tpu_torch import native

    return native.build("tpclient.c", "tpclient", ("cc", "gcc"), ("-O2", "-Wall"))


class _FrameWriter:
    """File-like that forwards writes as tagged frames on the socket."""

    def __init__(self, conn: socket.socket, tag: bytes) -> None:
        self._conn = conn
        self._tag = tag

    def write(self, s) -> int:
        data = s.encode() if isinstance(s, str) else bytes(s)
        if data:
            self._conn.sendall(self._tag + struct.pack("<I", len(data)) + data)
        return len(s)

    def flush(self) -> None:  # frames are unbuffered
        pass


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed mid-request")
        buf += chunk
    return buf


def _dispatch(tool: str, argv: list[str]) -> int:
    if tool == "twopaco":
        from twopaco_tpu_torch.cli import twopaco as mod
    elif tool == "graphdump":
        from twopaco_tpu_torch.cli import graphdump as mod
    elif tool == "naive":
        from twopaco_tpu_torch.cli import naive as mod
    else:
        raise ValueError(f"unknown tool {tool!r}")
    return mod.main(argv)


def _release_device() -> None:
    """Wait for the request's device work and return the allocator's
    cached blocks (the kernels' kept look-back scratch stays)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _serve_one(conn: socket.socket) -> bool:
    """Handle one request; returns False if the daemon should stop."""
    (n,) = struct.unpack("<I", _recv_exact(conn, 4))
    req = json.loads(_recv_exact(conn, n))
    if not isinstance(req, dict):
        raise ValueError("the request is not a JSON object")
    if req.get("tool") == "__shutdown__":
        conn.sendall(b"X" + struct.pack("<I", 0))
        return False
    out = _FrameWriter(conn, b"O")
    err = _FrameWriter(conn, b"E")
    old = sys.stdout, sys.stderr, os.getcwd()
    rc = 1
    try:
        sys.stdout, sys.stderr = out, err
        if req.get("cwd"):
            os.chdir(req["cwd"])
        # argparse calls sys.exit on -h/usage errors; map to rc
        try:
            rc = int(_dispatch(req["tool"], req["argv"]) or 0)
        except SystemExit as e:
            rc = int(e.code or 0)
    except Exception:
        err.write(traceback.format_exc())
        rc = 1
    finally:
        sys.stdout, sys.stderr = old[0], old[1]
        try:
            os.chdir(old[2])
        except OSError:
            pass
    try:
        _release_device()
    except RuntimeError:  # a CUDA error the request left behind
        err.write(traceback.format_exc())
        rc = 1
    conn.sendall(b"X" + struct.pack("<I", rc))
    return True


def warm(device: str):
    """Load, before the first request, what every request would pay: the
    native host library, and on cuda the kernel library and the CUDA
    context (in that order: the builds run compilers as child processes,
    and the daemon starts none after CUDA is initialised); then the
    passes and graphdump. Raises RuntimeError where the device is cuda
    and there is no card (passes/sortpipe.py resolve_device)."""
    import torch

    from twopaco_tpu_torch.io import native
    from twopaco_tpu_torch.passes.sortpipe import resolve_device

    dev = resolve_device(device)
    native.available()
    if dev.type == "cuda":
        from twopaco_tpu_torch.kernels import build

        build.lib()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    from twopaco_tpu_torch.formats import graphdump  # noqa: F401
    from twopaco_tpu_torch.parallel import distpipe  # noqa: F401
    from twopaco_tpu_torch.passes import bloompipe, pipeline, sortpipe  # noqa: F401
    return dev


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="twopaco-serve")
    p.add_argument("--socket", default=DEFAULT_SOCKET)
    p.add_argument(
        "--idle-timeout", type=float,
        default=float(os.environ.get("TWOPACO_SERVER_IDLE_S", 1800)),
        help="Exit after this many seconds with no requests (0 = never);"
        " the daemon holds a CUDA context and its kept device memory, so"
        " an abandoned server must release them on its own",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"],
        default=os.environ.get("TWOPACO_SERVER_DEVICE", "cuda"),
        help="The device the daemon warms: cuda (the default; exits"
        " non-zero without a card) or cpu",
    )
    args = p.parse_args(argv)

    try:
        dev = warm(args.device)
    except RuntimeError as e:  # no card, or the kernel library failed to build
        print(f"Error: {e}", file=sys.stderr, flush=True)
        return 1
    try:
        os.unlink(args.socket)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(args.socket)
    srv.listen(8)
    print(f"twopaco server ready on {args.socket} (device {dev})", flush=True)
    try:
        while True:
            if args.idle_timeout:
                srv.settimeout(args.idle_timeout)
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                print("idle timeout — exiting", flush=True)
                return 0
            with conn:
                try:
                    if not _serve_one(conn):
                        return 0
                except (ConnectionError, OSError, ValueError) as e:
                    print(f"request aborted: {e}", file=sys.stderr, flush=True)
    finally:
        srv.close()
        try:
            os.unlink(args.socket)
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
