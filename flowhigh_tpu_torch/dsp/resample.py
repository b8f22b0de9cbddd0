"""Polyphase resampling — ``scipy.signal.resample_poly`` parity, on the device.

Counterpart of ``flowhigh_tpu/dsp/resample.py``. The FIR is designed once on
the host (Kaiser beta=5.0 windowed sinc, exactly like scipy, or the longer
soxr_hq-grade design of ``upsampling_method="librosa"``) and split into a
polyphase bank; the resampler is then one strided ``F.conv1d`` with ``up``
output channels (one per phase) whose outputs are interleaved.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin

from ..utils import cudnn_f32, device_constant


DESIGNS = ("scipy", "soxr_hq")


@functools.lru_cache(maxsize=64)
def _design(up: int, down: int,
            design: str = "scipy") -> tuple[np.ndarray, int, int]:
    """Windowed-sinc FIR + alignment offsets.

    ``"scipy"``: Kaiser beta=5.0, 10*max_rate half-length, cutoff
    1/max_rate: ``scipy.signal.resample_poly`` exactly. ``"soxr_hq"``: the
    reference's ``upsampling_method="librosa"`` calls librosa's soxr_hq
    resampler, a C library with no public taps, so this design meets its
    specification instead (about 120 dB stopband, passband to about 0.92
    Nyquist): cutoff 0.96/max_rate, 32*max_rate half-length, Kaiser
    beta = 0.1102 * (120 - 8.7). Both as the JAX package's ``_design``.
    Returns (pre-padded filter h, n_pre_remove, half_len) such that output
    k of the decimated full convolution at index ``k + n_pre_remove``
    aligns with scipy's output."""
    max_rate = max(up, down)
    if design == "scipy":
        f_c, half_len, beta = 1.0 / max_rate, 10 * max_rate, 5.0
    elif design == "soxr_hq":
        f_c, half_len = 0.96 / max_rate, 32 * max_rate
        beta = 0.1102 * (120.0 - 8.7)
    else:
        raise ValueError(f"unknown FIR design {design!r} (options: {DESIGNS})")
    h = firwin(2 * half_len + 1, f_c,
               window=("kaiser", beta)).astype(np.float64)
    h *= up
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    n_pre_remove = (half_len + n_pre_pad) // down
    return h.astype(np.float32), n_pre_remove, half_len


def output_length(n: int, up: int, down: int) -> int:
    g = math.gcd(up, down)
    up, down = up // g, down // g
    return -(-(n * up) // down)


@functools.lru_cache(maxsize=64)
def _polyphase_bank(up: int, down: int,
                    design: str = "scipy") -> tuple[np.ndarray, int, int]:
    """W[phase, taps] with y[c + m*up] = sum_k W[c, k] * x[s0 + m*down + k]
    (cross-correlation); returns (W, s0, n_taps)."""
    h, pre, _ = _design(up, down, design)
    lh = len(h)
    # choose s0 so that k >= 0 covers every tap for every phase
    s0 = min(((c + pre) * down - (lh - 1)) // up for c in range(up))
    k_max = max(((c + pre) * down) // up for c in range(up)) - s0
    w = np.zeros((up, k_max + 1), np.float32)
    for c in range(up):
        for k in range(k_max + 1):
            idx = (c + pre) * down - (s0 + k) * up
            if 0 <= idx < lh:
                w[c, k] = h[idx]
    return w, s0, k_max + 1


def resample_poly(x: torch.Tensor, up: int, down: int,
                  design: str = "scipy") -> torch.Tensor:
    """[..., T] -> [..., ceil(T*up/down)] float32, numerically scipy's for
    ``design="scipy"``; ``"soxr_hq"`` takes the librosa-grade FIR (see
    ``_design``)."""
    if design not in DESIGNS:
        raise ValueError(f"unknown FIR design {design!r} (options: {DESIGNS})")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    n_in = x.shape[-1]
    n_out = output_length(n_in, up, down)
    w, s0, kw = _polyphase_bank(up, down, design)

    m_out = -(-n_out // up)  # per-phase output count
    pad_left = max(0, -s0)
    j_max = s0 + (m_out - 1) * down + kw
    pad_right = max(0, j_max - n_in)

    batch_shape = x.shape[:-1]
    lhs = F.pad(x.reshape(-1, 1, n_in).float(), (pad_left, pad_right))
    start = s0 + pad_left
    if start > 0:
        lhs = lhs[..., start:]
    rhs = device_constant(w, x.device).reshape(up, 1, kw)
    with cudnn_f32():
        out = F.conv1d(lhs, rhs, stride=down)          # [N, up, >= m_out]
    out = out[:, :, :m_out]
    y = out.transpose(1, 2).reshape(out.shape[0], -1)  # interleave phases
    return y[:, :n_out].reshape(batch_shape + (n_out,))


def upsample_to_48k(x: torch.Tensor, sr: int, target_sr: int = 48000,
                    design: str = "scipy") -> torch.Tensor:
    """The upsampling step of ``generate`` alone: [..., T] at ``sr`` ->
    [..., ceil(T * target_sr / sr)] on ``x``'s device."""
    return resample_poly(x, target_sr, sr, design)
