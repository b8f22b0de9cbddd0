"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/flowhigh_tpu_torch/<name>-<hash>.so``
beside the package (the hash is of the source, so an edited kernel is
rebuilt). All sources compile at once, one ``nvcc`` process each, at the
first launch of any kernel; the libraries are loaded with ``ctypes``.
Importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "flowhigh_tpu_torch"
SOURCES = ("snake_aa", "conv1d_same", "conv_transpose1d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each C entry point, in declaration order
SIGNATURES = {
    "snake_aa": {"snake_aa_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "conv1d_same": {"conv1d_same_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _I, _F, _P],
                    "conv1d_same_supported": [_I, _I]},
    "conv_transpose1d": {
        "conv_transpose1d_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "conv_transpose1d_supported": [_I, _I]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {name: library path}. Raises with nvcc's output on failure.
    ``-Xptxas -v`` register and shared-memory reports land in
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _target(name) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for lib_name, path in paths.items():
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[lib_name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[lib_name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
