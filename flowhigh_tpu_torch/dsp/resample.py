"""Polyphase resampling — ``scipy.signal.resample_poly`` parity, on the device.

Counterpart of ``flowhigh_tpu/dsp/resample.py``. The FIR is designed once on
the host (Kaiser beta=5.0 windowed sinc, exactly like scipy) and split into a
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

from ..utils import cudnn_f32


@functools.lru_cache(maxsize=64)
def _design(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """Windowed-sinc FIR + alignment offsets (scipy design: Kaiser beta=5.0,
    10*max_rate half-length). Returns (pre-padded filter h, n_pre_remove,
    half_len) such that output k of the decimated full convolution at index
    ``k + n_pre_remove`` aligns with scipy's output."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)).astype(np.float64)
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
def _polyphase_bank(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """W[phase, taps] with y[c + m*up] = sum_k W[c, k] * x[s0 + m*down + k]
    (cross-correlation); returns (W, s0, n_taps)."""
    h, pre, _ = _design(up, down)
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


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """[..., T] -> [..., ceil(T*up/down)] float32, numerically scipy's."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    n_in = x.shape[-1]
    n_out = output_length(n_in, up, down)
    w, s0, kw = _polyphase_bank(up, down)

    m_out = -(-n_out // up)  # per-phase output count
    pad_left = max(0, -s0)
    j_max = s0 + (m_out - 1) * down + kw
    pad_right = max(0, j_max - n_in)

    batch_shape = x.shape[:-1]
    lhs = F.pad(x.reshape(-1, 1, n_in).float(), (pad_left, pad_right))
    start = s0 + pad_left
    if start > 0:
        lhs = lhs[..., start:]
    rhs = torch.from_numpy(w).to(x.device).reshape(up, 1, kw)
    with cudnn_f32():
        out = F.conv1d(lhs, rhs, stride=down)          # [N, up, >= m_out]
    out = out[:, :, :m_out]
    y = out.transpose(1, 2).reshape(out.shape[0], -1)  # interleave phases
    return y[:, :n_out].reshape(batch_shape + (n_out,))
