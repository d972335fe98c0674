"""Serve mode of the port (twopaco_tpu_torch/cli/serve.py and its client
native/tpclient.c) on the CPU: a daemon warmed with --device cpu answers
requests in the JAX package's wire format with the direct CLI's bytes.

Every wait is bounded (sockets time out, processes are waited on with a
timeout and killed on failure): a hung daemon fails its test."""

import contextlib
import io
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from twopaco_tpu_torch.cli import graphdump as graphdump_cli
from twopaco_tpu_torch.cli import naive as naive_cli
from twopaco_tpu_torch.cli import serve
from twopaco_tpu_torch.cli import twopaco as twopaco_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "tests", "golden", "example.fa")
SOCKET_WAIT_S = 120
REQUEST_TIMEOUT_S = 300


@contextlib.contextmanager
def _sock_dir():
    """A directory for sockets directly under the temporary root: a unix
    socket's path must stay within 107 bytes, which pytest's deeper
    tmp_path may pass."""
    d = tempfile.mkdtemp(prefix="tps")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TWOPACO_SERVER")}
    env.update(extra)
    return env


def _start(sock, tmp, *args, env=None):
    """A daemon process on sock (output to tmp/server.log), once its socket
    exists; raises if it exits or the socket does not appear in time."""
    log = open(os.path.join(tmp, "server.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "twopaco_tpu_torch.cli.serve", "--socket", sock, *args],
        cwd=ROOT, env=env or _env(), stdout=log, stderr=subprocess.STDOUT,
    )
    log.close()
    deadline = time.time() + SOCKET_WAIT_S
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() > deadline:
            _stop(proc)
            with open(os.path.join(tmp, "server.log")) as f:
                raise RuntimeError(f"no daemon on {sock}: {f.read()}")
        time.sleep(0.1)
    return proc


def _stop(proc) -> int:
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise


def request(sock_path, tool, argv, cwd=None):
    """Python mini-client speaking the tpclient protocol -> (rc, out, err)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(REQUEST_TIMEOUT_S)
        s.connect(sock_path)
        req = json.dumps({"tool": tool, "argv": argv, "cwd": cwd or os.getcwd()}).encode()
        s.sendall(struct.pack("<I", len(req)) + req)

        def recv_exact(n):
            buf = b""
            while len(buf) < n:
                chunk = s.recv(n - len(buf))
                assert chunk, "server closed mid-response"
                buf += chunk
            return buf

        out, err = b"", b""
        while True:
            tag = recv_exact(1)
            (n,) = struct.unpack("<I", recv_exact(4))
            if tag == b"X":
                return n, out.decode(), err.decode()
            payload = recv_exact(n)
            if tag == b"O":
                out += payload
            else:
                err += payload


@pytest.fixture(scope="module")
def server():
    with _sock_dir() as tmp:
        sock = os.path.join(tmp, "tp.sock")
        proc = _start(sock, tmp, "--device", "cpu", "--idle-timeout", "600")
        try:
            yield sock
        finally:
            if proc.poll() is None:
                with contextlib.suppress(OSError):
                    request(sock, "__shutdown__", [])
            _stop(proc)


def _direct(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def direct_dbg(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("direct") / "direct.dbg")
    _direct(twopaco_cli.main, ["--device", "cpu", "-k", "11", "-f", "16", "-o", out, EXAMPLE])
    return out


def test_twopaco_round_trip(server, direct_dbg, tmp_path):
    out = str(tmp_path / "srv.dbg")
    rc, stdout, err = request(server, "twopaco",
                              ["--device", "cpu", "-k", "11", "-f", "16", "-o", out, EXAMPLE])
    assert rc == 0, err
    assert "Distinct junctions = 7" in stdout
    assert _read(out) == _read(direct_dbg)


@pytest.mark.parametrize("fmt", ["group", "gfa1"])
def test_graphdump_round_trip(server, direct_dbg, fmt):
    argv = ["-f", fmt, "-k", "11", direct_dbg] + (["-s", EXAMPLE] if fmt == "gfa1" else [])
    rc, text, err = request(server, "graphdump", argv)
    assert rc == 0, err
    assert text and text == _direct(graphdump_cli.main, argv)


def test_naive_round_trip(server, tmp_path):
    out, direct = str(tmp_path / "srv.dbg"), str(tmp_path / "direct.dbg")
    rc, stdout, err = request(server, "naive", ["-k", "11", "-o", out, EXAMPLE])
    assert rc == 0, err
    assert stdout == _direct(naive_cli.main, ["-k", "11", "-o", direct, EXAMPLE])
    assert _read(out) == _read(direct)


def test_relative_paths_resolve_against_cwd(server, direct_dbg, tmp_path):
    shutil.copy(EXAMPLE, tmp_path / "in.fa")
    rc, _, err = request(server, "twopaco",
                         ["--device", "cpu", "-k", "11", "-f", "16", "-o", "rel.dbg", "in.fa"],
                         cwd=str(tmp_path))
    assert rc == 0, err
    assert _read(tmp_path / "rel.dbg") == _read(direct_dbg)


def test_bad_args_answer_2_and_the_daemon_serves_on(server, tmp_path):
    rc, _, err = request(server, "twopaco", ["--definitely-not-a-flag"])
    assert rc == 2 and "unrecognized arguments" in err
    rc, _, err = request(server, "twopaco", ["-k", "12", "x.fa"])
    assert rc == 1 and "odd" in err
    out = str(tmp_path / "after.dbg")
    rc, _, err = request(server, "twopaco",
                         ["--device", "cpu", "-k", "11", "-f", "16", "-o", out, EXAMPLE])
    assert rc == 0, err


def test_unknown_tool(server):
    rc, _, err = request(server, "nonsense", [])
    assert rc == 1 and "unknown tool 'nonsense'" in err


@pytest.mark.parametrize("how", ["shutdown", "idle"])
def test_daemon_exits_0(how):
    with _sock_dir() as tmp:
        sock = os.path.join(tmp, "s.sock")
        proc = _start(sock, tmp, "--device", "cpu", "--idle-timeout",
                      "1" if how == "idle" else "600")
        if how == "shutdown":
            assert request(sock, "__shutdown__", []) == (0, "", "")
        assert _stop(proc) == 0
        assert not os.path.exists(sock)


@pytest.fixture(scope="module")
def tpclient():
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler found")
    return str(serve.client_path())


def test_tpclient_round_trip(server, tpclient, direct_dbg, tmp_path):
    out = str(tmp_path / "cli.dbg")
    env = _env(TWOPACO_SERVER_SOCKET=server)
    r = subprocess.run([tpclient, "twopaco", "--device", "cpu", "-k", "11", "-f", "16",
                        "-o", out, EXAMPLE], env=env, capture_output=True, text=True,
                       timeout=REQUEST_TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    assert "Distinct junctions = 7" in r.stdout
    assert _read(out) == _read(direct_dbg)
    r = subprocess.run([tpclient, "twopaco", "--nope"], env=env, capture_output=True,
                       text=True, timeout=REQUEST_TIMEOUT_S)
    assert r.returncode == 2 and "unrecognized arguments" in r.stderr


def test_tpclient_spawns_the_daemon(tpclient, direct_dbg, tmp_path):
    """With no socket, the client starts `python -m twopaco_tpu_torch.cli.serve`
    detached, waits for it, and is served; __shutdown__ stops it."""
    sock_dir = tempfile.mkdtemp(prefix="tps")
    sock = os.path.join(sock_dir, "spawned.sock")
    log = str(tmp_path / "spawned.log")
    env = _env(TWOPACO_SERVER_SOCKET=sock, TWOPACO_PYTHON=sys.executable,
               TWOPACO_SERVER_DEVICE="cpu", TWOPACO_SERVER_LOG=log,
               TWOPACO_SERVER_IDLE_S="120", TWOPACO_CLIENT_WAIT_S=str(SOCKET_WAIT_S))
    out = str(tmp_path / "spawned.dbg")
    try:
        r = subprocess.run([tpclient, "twopaco", "--device", "cpu", "-k", "11", "-f", "16",
                            "-o", out, EXAMPLE], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=SOCKET_WAIT_S + REQUEST_TIMEOUT_S)
        assert r.returncode == 0, r.stderr + (open(log).read() if os.path.exists(log) else "")
        assert _read(out) == _read(direct_dbg)
        with open(log) as f:
            assert f"twopaco server ready on {sock} (device cpu)" in f.read()
    finally:
        if os.path.exists(sock):
            subprocess.run([tpclient, "__shutdown__"], env=env, timeout=60)
    deadline = time.time() + 30
    while os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.1)
    assert not os.path.exists(sock)
    shutil.rmtree(sock_dir, ignore_errors=True)


def test_cuda_daemon_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the cuda daemon starts")
    sock = str(tmp_path / "cuda.sock")
    proc = subprocess.run(
        [sys.executable, "-m", "twopaco_tpu_torch.cli.serve", "--device", "cuda",
         "--socket", sock], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not os.path.exists(sock)
