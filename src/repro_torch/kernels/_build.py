"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``.cu`` source exposes a plain C interface.  At first use it is
compiled by ``nvcc`` into a shared library under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``) and loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing here
runs at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "load", "build_all", "build_log"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_CSRC))), "build", "kernels"
)

_COMMON = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # precise division and expf: no fast math anywhere (acceptance
    # decisions of the annealer must match the plain version bit for bit)
    "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
]

# source stem -> extra nvcc flags.  The annealer also forbids FMA
# contraction so every update rounds exactly as the plain version does.
SOURCES = {
    "sa_sweep": ["-fmad=false"],
    "bitlinear": [],
}

_libs: dict = {}
_logs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA toolkit required to build kernels)")
    return path


def _target(name: str) -> tuple[str, list]:
    src = os.path.join(_CSRC, f"{name}.cu")
    flags = _COMMON + SOURCES[name]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(_BUILD, f"lib{name}-{digest}.so")
    return out, [_nvcc(), *flags, "-o", _tmp(out), src]


def _tmp(out: str) -> str:
    # per-process name: concurrent builds never write the same file, and
    # the rename publishes a complete library atomically
    return f"{out}.{os.getpid()}.tmp"


def _finish(name: str, out: str, proc: subprocess.CompletedProcess) -> None:
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{_logs[name]}")
    os.replace(_tmp(out), out)


def build_all() -> dict:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns {name: library path}."""
    os.makedirs(_BUILD, exist_ok=True)
    procs, paths = {}, {}
    for name in SOURCES:
        out, cmd = _target(name)
        paths[name] = out
        if not os.path.exists(out):
            procs[name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ))
    for name, (out, p) in procs.items():
        stdout, stderr = p.communicate()
        _finish(name, out, subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, cmd = _target(name)
            if not os.path.exists(out):
                os.makedirs(_BUILD, exist_ok=True)
                _finish(name, out, subprocess.run(cmd, capture_output=True, text=True))
            lib = _libs[name] = ctypes.CDLL(out)
        return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    a source built in this process; empty when the library was cached."""
    return _logs.get(name, "")
