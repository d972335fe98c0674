"""The port's host programs in C and C++, built at first use.

fastaio.cpp (the FASTA encoder and record emit, bound by io/native.py)
and tpclient.c (the serve client, cli/serve.py client_path) are compiled
by the host's compiler into native/build/ beside them. A file's name
carries a hash of its source, the flags, the compiler's version line and
the CPU's feature flags, so an edited source is rebuilt and a
-march=native build is not reused on another CPU; the compiler's output
goes to a .log of the same name. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
BUILD_TIMEOUT_S = 300


class HostBuildError(RuntimeError):
    pass


def _cpu_flags() -> str:
    """The host CPU's feature flags (Linux), so that a -march=native build
    is not reused on another CPU that shares the checkout."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def build(source: str, stem: str, compilers, flags, suffix: str = "",
          build_dir: Path = BUILD_DIR) -> Path:
    """Path of SRC_DIR/source compiled with flags by the first of
    compilers found on PATH; built when absent. Processes that build at
    once each compile in a directory of their own and move the result into
    place with os.replace, so every reader finds a whole file. Raises
    HostBuildError when no compiler is found or the build fails."""
    cc = next((found for c in compilers if (found := shutil.which(c))), None)
    if cc is None:
        raise HostBuildError(f"no compiler found on PATH (tried {', '.join(compilers)})")
    src = SRC_DIR / source
    try:
        version = subprocess.run([cc, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.partition("\n")[0]
    except (OSError, subprocess.SubprocessError) as e:
        raise HostBuildError(f"{cc} --version failed: {e}") from None
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((version, *flags, _cpu_flags())).encode())
    name = f"{stem}-{h.hexdigest()[:16]}"
    target = Path(build_dir) / (name + suffix)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        out = os.path.join(tmp, "out")
        cmd = [cc, *flags, "-o", out, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            log, ok = proc.stdout + proc.stderr, proc.returncode == 0
        except (OSError, subprocess.TimeoutExpired) as e:
            log, ok = str(e), False
        with open(os.path.join(tmp, "log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
        os.replace(os.path.join(tmp, "log"), target.parent / f"{name}.log")
        if not ok:
            raise HostBuildError(f"{os.path.basename(cc)} failed on {source}:\n{log[-2000:]}")
        os.replace(out, target)
    return target
