"""Native (C++) host-DSP path for the training data pipeline.

Counterpart of ``flowhigh_tpu/native``, on a copy of its C++ source (this
package imports nothing of the JAX one). The reference's degradation runs
scipy kernels inside torch DataLoader worker processes (reference:
src/flowhigh/train/data.py:92-131,169-171). This package provides a
drop-in native implementation of the two hot primitives — ``sosfiltfilt``
and ``resample_poly`` — plus a fused ``host_degrade`` matching
``flowhigh_tpu_torch.dsp.filters.host_degrade``. Filter *design* stays in
scipy but is cached per parameter set (the reference redesigns the
Chebyshev cascade and the Kaiser FIR for every clip, which is a third of
its per-clip cost).

Semantics are scipy-exact: same odd-extension padding and ``sosfilt_zi``
initial conditions for ``sosfiltfilt``, same Kaiser-5.0 firwin design,
zero-padding and output alignment for ``resample_poly``. Parity is pinned by
``tests/test_torch_data.py``.

Use ``available()`` before calling: the library is g++-compiled on first use
and every entry point raises ``NativeUnavailable`` when compilation is not
possible (callers fall back to scipy). Set ``FLOWHIGH_NO_NATIVE=1`` to force
the scipy path.
"""

from __future__ import annotations

import ctypes
import math
import os
from functools import lru_cache

import numpy as np

__all__ = [
    "available", "sosfiltfilt", "resample_poly", "host_degrade",
    "NativeUnavailable",
]

_I64 = ctypes.c_int64
_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


class NativeUnavailable(RuntimeError):
    """The native library could not be built/loaded on this host."""


_lib = None
_lib_error: Exception | None = None


def _load():
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise NativeUnavailable(str(_lib_error))
    if os.environ.get("FLOWHIGH_NO_NATIVE"):
        _lib_error = RuntimeError("disabled via FLOWHIGH_NO_NATIVE")
        raise NativeUnavailable(str(_lib_error))
    try:
        from .build import build_library
        lib = ctypes.CDLL(str(build_library()))
        lib.fh_sosfilt.argtypes = [_DP, _I64, _DP, _I64, _DP, _DP]
        lib.fh_sosfilt_zi.argtypes = [_DP, _I64, _DP]
        lib.fh_sosfiltfilt.argtypes = [_DP, _I64, _DP, _I64, _I64, _DP]
        lib.fh_upfirdn.argtypes = [_DP, _I64, _DP, _I64, _I64, _I64, _I64,
                                   _I64, _DP]
        lib.fh_degrade.argtypes = [
            _DP, _I64, _I64,            # sos, ns, edge
            _DP, _I64,                  # wave, n
            _DP, _I64, _I64, _I64, _I64, _I64,  # h_dn, nh, up, down, k0, n_mid
            _DP, _I64, _I64, _I64, _I64, _I64,  # h_up, nh, up, down, k0, n_up
            _DP, _I64,                  # out, n_out
        ]
        for fn in (lib.fh_sosfilt, lib.fh_sosfilt_zi, lib.fh_sosfiltfilt,
                   lib.fh_upfirdn, lib.fh_degrade):
            fn.restype = None
    except Exception as e:  # missing g++, read-only cache, bad CDLL, ...
        _lib_error = e
        raise NativeUnavailable(str(e)) from e
    _lib = lib
    return lib


def available() -> bool:
    """True iff the native library is built and loadable on this host."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


# --- sosfiltfilt -------------------------------------------------------------

def _filtfilt_edge(sos: np.ndarray) -> int:
    # scipy.signal.sosfiltfilt's default padlen
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min(int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum()))
    return ntaps * 3


def sosfiltfilt(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """scipy.signal.sosfiltfilt(sos, x) (1-D, default odd padding)."""
    lib = _load()
    sos = np.ascontiguousarray(sos, np.float64)
    # normalize a0 like scipy does up front
    if not np.all(sos[:, 3] == 1.0):
        sos = sos / sos[:, 3:4]
    x = np.ascontiguousarray(x, np.float64)
    assert x.ndim == 1
    edge = _filtfilt_edge(sos)
    if x.shape[0] <= edge:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen, "
            f"which is {edge}.")
    y = np.empty_like(x)
    lib.fh_sosfiltfilt(sos, sos.shape[0], x, x.shape[0], edge, y)
    return y


# --- resample_poly -----------------------------------------------------------

@lru_cache(maxsize=512)
def _resample_design(up: int, down: int):
    """scipy.signal.resample_poly's Kaiser-5.0 FIR + output alignment for a
    reduced up/down pair: (h_prepadded, n_pre_remove). Trailing zero-pad is
    unnecessary — the kernel clamps tap ranges, and zero taps contribute 0."""
    from scipy.signal import firwin
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down  # scipy quirk: == down when divisible
    n_pre_remove = (half_len + n_pre_pad) // down
    h_full = np.concatenate([np.zeros(n_pre_pad), h])
    h_full.setflags(write=False)
    return h_full, n_pre_remove


def _resample_len(n_in: int, up: int, down: int) -> int:
    return n_in * up // down + bool((n_in * up) % down)


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly(x, up, down) (1-D, default Kaiser window)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    assert x.ndim == 1
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == 1 and down == 1:
        return x.copy()
    h, k0 = _resample_design(up, down)
    n_out = _resample_len(x.shape[0], up, down)
    y = np.empty(n_out, np.float64)
    lib.fh_upfirdn(h, h.shape[0], x, x.shape[0], up, down, k0, n_out, y)
    return y


# --- fused degradation chain -------------------------------------------------

@lru_cache(maxsize=4096)
def _cheby1_design(order: int, ripple: float, hi: float):
    from scipy.signal import cheby1
    sos = cheby1(order, ripple, hi, btype="lowpass",
                 output="sos").astype(np.float64)
    sos.setflags(write=False)
    return sos


def host_degrade(wave: np.ndarray, sr: int, random_sr: int, order: int,
                 ripple: float) -> np.ndarray:
    """Native twin of ``dsp.filters.host_degrade`` (one C call for the whole
    cheby1-filtfilt + down/up resample chain; reference: data.py:110-123)."""
    lib = _load()
    wave = np.ascontiguousarray(wave, np.float64)
    n = wave.shape[0]
    sos = _cheby1_design(int(order), float(ripple),
                         (random_sr // 2) / (sr // 2))
    edge = _filtfilt_edge(sos)
    if n <= edge:
        raise ValueError(f"input length {n} must exceed padlen {edge}")

    g = math.gcd(random_sr, sr)
    dn_up, dn_down = random_sr // g, sr // g
    up_up, up_down = sr // g, random_sr // g
    h_dn, dn_k0 = _resample_design(dn_up, dn_down)
    h_up, up_k0 = _resample_design(up_up, up_down)
    n_mid = _resample_len(n, dn_up, dn_down)
    n_up = _resample_len(n_mid, up_up, up_down)

    out = np.empty(n, np.float64)
    lib.fh_degrade(sos, sos.shape[0], edge, wave, n,
                   h_dn, h_dn.shape[0], dn_up, dn_down, dn_k0, n_mid,
                   h_up, h_up.shape[0], up_up, up_down, up_k0, n_up,
                   out, n)
    return out
