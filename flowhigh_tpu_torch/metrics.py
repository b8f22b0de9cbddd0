"""Spectral metrics for the long-form modes: counterpart of
``log_spectral_distance`` and ``boundary_lsd`` in ``flowhigh_tpu/metrics.py``,
over the port's own STFT (``dsp/stft.py``; cuFFT on the card)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .dsp import stft_magnitude


def log_spectral_distance(ref, est, n_fft: int = 2048, hop_length: int = 480,
                          eps: float = 1e-8) -> torch.Tensor:
    """LSD in dB of [B, T] waveforms (tensors or arrays) -> [B]:
    mean over frames of sqrt(mean over bins of
    (log10 max(|S_ref|^2, eps) - log10 max(|S_est|^2, eps))^2), on centred
    frames with zero padding."""
    ref, est = torch.as_tensor(ref), torch.as_tensor(est)
    mr, me = (stft_magnitude(x, n_fft, hop_length, n_fft, center=True,
                             pad_mode="constant") for x in (ref, est))
    lr = torch.log10(torch.clamp(mr * mr, min=eps))
    le = torch.log10(torch.clamp(me * me, min=eps))
    per_frame = torch.sqrt(torch.mean((lr - le) ** 2, dim=-2))  # [B, frames]
    return per_frame.mean(dim=-1)


def boundary_lsd(ref, est, boundaries: Sequence[int], window: int = 24000,
                 n_fft: int = 2048, hop_length: int = 480) -> float:
    """Mean LSD (dB) over the windows of +-``window`` samples around each
    chunk boundary: the seam metric of chunked long-form inference. ``ref``
    is the single-pass output, ``est`` the stitched one, ``boundaries`` the
    sample indices where ``est``'s chunks meet; windows shorter than
    ``n_fft`` are skipped, and no window gives 0."""
    ref = np.asarray(ref, np.float32).reshape(-1)
    est = np.asarray(est, np.float32).reshape(-1)
    t = min(len(ref), len(est))
    vals = []
    for b in boundaries:
        lo, hi = max(0, int(b) - window), min(t, int(b) + window)
        if hi - lo < n_fft:
            continue
        vals.append(float(log_spectral_distance(
            torch.from_numpy(ref[None, lo:hi]),
            torch.from_numpy(est[None, lo:hi]), n_fft, hop_length)[0]))
    return float(np.mean(vals)) if vals else 0.0
