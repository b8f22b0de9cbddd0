"""Mel codec frontend — counterpart of ``encode`` in
``flowhigh_tpu/models/melvoco.py``: reflect pad (n_fft - hop) / 2,
center=False STFT, sqrt(re^2 + im^2 + 1e-9) magnitude, Slaney mel matmul,
log-clamp 1e-5."""

from __future__ import annotations

import torch

from ..config import MelConfig
from ..dsp import apply_mel, log_compress, mel_filterbank, stft_magnitude


def encode(audio: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, T] in [-1, 1] -> [B, frames, n_mels] float32 log-mel.

    The STFT magnitude is taken in float64. Bins just above the 1e-5 log
    clamp are as small as a float32 FFT's rounding error, so in float32
    their log-mel depended on the FFT library (cuFFT on the card, another
    FFT on the CPU), enough to move the 48 kHz output of a 1 s clip by 3e-3
    between the two (chip_smoke.py phase 3, H100). In float64 both agree."""
    mag = stft_magnitude(audio.double(), cfg.n_fft, cfg.hop_length,
                         cfg.win_length, center=False, pad_mode="reflect",
                         eps=1e-9).float()
    basis = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                           cfg.f_min, cfg.f_max)
    mel = log_compress(apply_mel(mag, basis), 1e-5)
    return mel.transpose(-1, -2)
