"""Evaluation metrics and the RTF timer — counterpart of
``flowhigh_tpu/metrics.py``: log-spectral distance (whole band, high band,
around chunk seams), SNR, mel L1, over the port's own STFT
(``dsp/stft.py``; cuFFT on the card)."""

from __future__ import annotations

import time
from typing import Callable, Sequence

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


def high_band_lsd(ref, est, n_fft: int = 2048, hop_length: int = 480,
                  cutoff_hz: float = 8000.0, sr: int = 48000) -> torch.Tensor:
    """LSD (dB, [B]) over the bins above ``cutoff_hz`` only: the band that
    super-resolution has to invent. The first bin kept is
    int(cutoff_hz / (sr / 2) * (bins - 1)); magnitude floor 1e-8."""
    ref, est = torch.as_tensor(ref), torch.as_tensor(est)
    mr, me = (stft_magnitude(x, n_fft, hop_length, n_fft, center=True,
                             pad_mode="constant") for x in (ref, est))
    k0 = int(cutoff_hz / (sr / 2) * (mr.shape[-2] - 1))
    lr = torch.log10(torch.clamp(mr[..., k0:, :] ** 2, min=1e-8))
    le = torch.log10(torch.clamp(me[..., k0:, :] ** 2, min=1e-8))
    return torch.sqrt(torch.mean((lr - le) ** 2, dim=-2)).mean(dim=-1)


def snr_db(ref, est) -> torch.Tensor:
    """Time-domain SNR in dB over the last axis (noise power floored at
    1e-12)."""
    ref, est = torch.as_tensor(ref), torch.as_tensor(est)
    noise = ref - est
    p_sig = torch.sum(ref * ref, dim=-1)
    p_noise = torch.clamp(torch.sum(noise * noise, dim=-1), min=1e-12)
    return 10.0 * torch.log10(p_sig / p_noise)


def mel_l1(ref_mel, est_mel) -> torch.Tensor:
    """Mean absolute log-mel error."""
    return torch.mean(torch.abs(torch.as_tensor(ref_mel)
                                - torch.as_tensor(est_mel)))


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


def _synchronize() -> None:
    """Wait for the card's queued work, where this process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class RTFTimer:
    """Real-time factor of a function on ``audio_seconds`` of audio: host
    wall time of each call, the card synchronised before the clock is read
    (a CUDA call returns before its work is done)."""

    def __init__(self, audio_seconds: float):
        self.audio_seconds = audio_seconds
        self.samples: list[float] = []

    def measure(self, fn: Callable, *args, reps: int = 5, warmup: int = 1,
                **kwargs) -> float:
        """``warmup`` untimed calls, then ``reps`` timed ones; returns the
        RTF of the median."""
        for _ in range(warmup):
            fn(*args, **kwargs)
            _synchronize()
        for _ in range(reps):
            _synchronize()
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            _synchronize()
            self.samples.append(time.perf_counter() - t0)
        return self.rtf

    @property
    def p50_latency(self) -> float:
        return float(np.median(self.samples))

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.p50_latency
