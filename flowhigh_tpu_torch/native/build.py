"""Lazy g++ build of the native host-DSP library.

The shared object is compiled once per source hash into
``build/flowhigh_tpu_torch/`` beside the package (``FLOWHIGH_NATIVE_CACHE``
overrides the directory) and memoized; concurrent worker processes
serialize on a lock file. The name also hashes the host's CPU model and
flags: ``-march=native`` code built on one machine may not run on another
that finds the same build directory. No toolchain is assumed beyond a
system ``g++``; if compilation is impossible the caller falls back to
scipy (see ``native.available()``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).parent / "src" / "dsp_native.cpp"
_CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
              "-std=c++17"]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flowhigh_tpu_torch"


def _cache_dir() -> Path:
    env = os.environ.get("FLOWHIGH_NATIVE_CACHE")
    return Path(env) if env else BUILD_DIR


def _host_cpu() -> bytes:
    """The first CPU's model name and feature flags (what ``-march=native``
    compiles for), or nothing where /proc/cpuinfo is missing."""
    try:
        lines = Path("/proc/cpuinfo").read_bytes().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.split(b":")[0].strip()
            in (b"model name", b"flags", b"Features")]
    return b"\n".join(keep[:2])


def build_library() -> Path:
    """Compile (or reuse) the shared library; returns its path.

    Raises on any failure — callers treat exceptions as "native unavailable".
    """
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_CXX_FLAGS).encode()
                         + _host_cpu()).hexdigest()[:16]
    cache = _cache_dir()
    cache.mkdir(parents=True, exist_ok=True)
    so_path = cache / f"dsp_native-{tag}.so"
    if so_path.exists():
        return so_path

    lock_path = cache / f"dsp_native-{tag}.lock"
    with open(lock_path, "w") as lock:
        try:
            import fcntl
            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: races just rebuild redundantly
            pass
        if so_path.exists():  # built while we waited on the lock
            return so_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)  # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so_path
