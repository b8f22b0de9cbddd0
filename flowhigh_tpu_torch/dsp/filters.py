"""Chebyshev-I low-pass degradation filters — counterpart of
``flowhigh_tpu/dsp/filters.py``.

The training pipeline synthesizes paired low/high-res data by Chebyshev-I
low-pass filtering followed by down/up polyphase resampling
(reference: src/flowhigh/train/data.py:103-117). Filter *design* is host-side
scipy (static per (order, ripple, cutoff) — it is data-dependent per sample, so
it runs in the host data workers, like the reference's dataloader workers).

``sosfiltfilt`` is the device function (the JAX package's ``lax.scan``):
odd padding and ``sosfilt_zi`` scaling in PyTorch around two passes of the
sosfilt kernel on the card (``ops/iir.py``, ``csrc/sosfilt.cu``), or of
its plain version on the CPU. The host path stays the training default.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal as sps
import torch

from ..ops.iir import cascade, sosfilt


@functools.lru_cache(maxsize=256)
def cheby1_sos(order: int, ripple: float, wn: float) -> np.ndarray:
    """Low-pass Chebyshev-I cascade, [n_sections, 6] (b0 b1 b2 a0 a1 a2)."""
    return sps.cheby1(order, ripple, wn, btype="lowpass", output="sos").astype(np.float64)


def host_degrade(wave: np.ndarray, sr: int, random_sr: int, order: int,
                 ripple: float, engine: str = "auto") -> np.ndarray:
    """cheby1 + sosfiltfilt + down/up resample_poly, all host-side.

    Returns the band-limited-but-48k ``up_cond`` waveform, length-matched to
    ``wave`` (reference: src/flowhigh/train/data.py:110-123).

    ``engine``: "auto" uses the native C++ chain (``flowhigh_tpu_torch.native``,
    scipy-parity-tested, one call for the whole filter+resample chain) when
    the library builds on this host, falling back to scipy; "scipy"/"native"
    force a path ("native" raises ``NativeUnavailable`` if it can't build).
    ``FLOWHIGH_NO_NATIVE=1`` disables the native path globally.
    """
    if engine in ("auto", "native"):
        try:
            from .. import native
            return native.host_degrade(np.asarray(wave, np.float64), sr,
                                       random_sr, order, ripple)
        except Exception:
            if engine == "native":
                raise
    nyq = sr // 2
    hi = (random_sr // 2) / nyq
    sos = cheby1_sos(order, ripple, hi)
    d = sps.sosfiltfilt(sos, wave)
    down = sps.resample_poly(d, random_sr, sr)
    up = sps.resample_poly(down, sr, random_sr)
    if len(up) < len(wave):
        up = np.pad(up, (0, len(wave) - len(up)))
    elif len(up) > len(wave):
        up = up[: len(wave)]
    return np.ascontiguousarray(up)


# --- zero-phase IIR on the device --------------------------------------------

def padlen(sos: np.ndarray) -> int:
    """scipy.signal.sosfiltfilt's default odd-padding length."""
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min(int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum()))
    return 3 * ntaps


def sosfiltfilt(sos_np: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase filtering matching scipy.signal.sosfiltfilt (odd padding)
    over the last axis of ``x``, in float32 (the JAX function's precision):
    the sosfilt kernel on a CUDA tensor, its plain version on a CPU one."""
    sos_np = np.asarray(sos_np, dtype=np.float64)
    pad = padlen(sos_np)
    coefs = cascade(sos_np, sps.sosfilt_zi(sos_np))
    x = x.to(torch.float32)
    batch, t_len = x.shape[:-1], x.shape[-1]
    if t_len <= pad:
        raise ValueError(f"The length of the input vector x must be greater "
                         f"than padlen, which is {pad}.")
    x = x.reshape(-1, t_len)
    # odd-extension padding
    left = 2 * x[:, :1] - x[:, 1:pad + 1].flip(-1)
    right = 2 * x[:, -1:] - x[:, -pad - 1:-1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    y = sosfilt(coefs, ext)
    y = sosfilt(coefs, y, reverse=True)
    return y[:, pad:-pad].reshape(batch + (t_len,))
