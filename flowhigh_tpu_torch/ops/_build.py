"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/flowhigh_tpu_torch/<name>-<hash>.so``
beside the package (the hash is of the source, of the ``.cu`` files it
includes and of the shared headers ``csrc/*.cuh``, so an edited kernel is
rebuilt). All sources compile at once, one ``nvcc`` process each, at the
first launch of any kernel; the libraries are loaded with ``ctypes``.
Kernels B, C, D and E build their instances on bf16 feature maps from a
second source each (``<name>_bf16io.cu``, which includes ``<name>.cu``),
so that the two halves compile in parallel.
Importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "flowhigh_tpu_torch"
SOURCES = ("snake_aa", "conv1d_same", "conv1d_same_bf16io",
           "conv_transpose1d", "conv_transpose1d_bf16io", "act_conv1d",
           "act_conv1d_bf16io", "amp_unit", "amp_unit_bf16io", "flash_attn",
           "probe_snake", "probe_fir", "sosfilt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_CONV = [_P] * 7 + [_I] * 6 + [_F, _P]
_CONVT = [_P] * 4 + [_I] * 6 + [_P]
# D and E take the prepared weights' padded sizes (Cin_p, Cout_p)
_PAIR_MMA = [_P] * 10 + [_I] * 9 + [_F, _P]
_UNIT_MMA = [_P] * 13 + [_I] * 8 + [_F, _P]
# argument types of each C entry point, in declaration order; every entry
# point returns a C int (a CUDA error code or a flag) unless RESTYPES says.
# each int8 instance takes one more pointer per weight tensor (its scales)
# and one for the pre-pass's scratch
SIGNATURES = {
    "snake_aa": {**{name: [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
                    for name in ("snake_aa_f32", "snake_aa_f32_bf16io")},
                 "snake_aa_firs_f32": [_P, _P, _P, _I, _I, _P]},
    # kernels A, B, C, D and E: each instance also on bf16 feature maps
    # (``<entry>_bf16io``, the same arguments; B, C, D, E in their own
    # library)
    **{f"conv1d_same{io}": {
        "conv1d_same_f32" + io: _CONV, "conv1d_same_bf16" + io: _CONV,
        "conv1d_same_int8" + io: [_P, _P] + _CONV,
        "conv1d_same_supported": [_I, _I, _I, _I],
        "conv1d_same_weight_align": [_I],
        "conv1d_same_smem_bytes": [_I] * 4} for io in ("", "_bf16io")},
    **{f"conv_transpose1d{io}": {
        "conv_transpose1d_f32" + io: _CONVT,
        "conv_transpose1d_bf16" + io: _CONVT,
        "conv_transpose1d_supported": [_I, _I],
        "conv_transpose1d_weight_align": [_I]} for io in ("", "_bf16io")},
    **{f"act_conv1d{io}": {
        "act_conv1d_f32" + io: _PAIR_MMA, "act_conv1d_bf16" + io: _PAIR_MMA,
        "act_conv1d_int8" + io: [_P, _P] + _PAIR_MMA,
        "act_conv1d_smem_bytes": [_I] * 4} for io in ("", "_bf16io")},
    **{f"amp_unit{io}": {
        "amp_unit_f32" + io: _UNIT_MMA, "amp_unit_bf16" + io: _UNIT_MMA,
        "amp_unit_int8" + io: [_P] * 3 + _UNIT_MMA,
        "amp_unit_smem_bytes": [_I] * 4} for io in ("", "_bf16io")},
    "flash_attn": {"flash_attn_f32": [_P] * 5 + [_I] * 5 + [_F, _P],
                   "flash_attn_supported": [_I]},
    "probe_snake": {"snake_only_f32": [_P, _P, _P, _L, _I, _P]},
    # H takes a scratch of mxu_fir_scratch_bytes(L, bf16) bytes (its
    # weights laid out as the slices it reads)
    "probe_fir": {"mxu_fir_scratch_bytes": [_I, _I],
                  **{name: [_P] * 6 + [_I] * 3 + [_P] for name in (
                      "mxu_fir_f32", "mxu_fir_f32_dots", "mxu_fir_bf16",
                      "mxu_fir_bf16_dots")}},
    # the IIR pass takes its cascade by value (host pointer)
    "sosfilt": {"sosfilt_f32": [_P, _I, _P, _P, _I, _I, _I, _P],
                "sosfilt_max_sections": []},
}
RESTYPES = {"act_conv1d_smem_bytes": ctypes.c_longlong,
            "amp_unit_smem_bytes": ctypes.c_longlong,
            "mxu_fir_scratch_bytes": ctypes.c_longlong}

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
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for inc in re.findall(rb'#include "(\w+\.cu)"', src):
        h.update((CSRC_DIR / inc.decode()).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
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
                    getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
                _libs[lib_name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
