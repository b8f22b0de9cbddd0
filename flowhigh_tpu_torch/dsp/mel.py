"""Mel filterbank (Slaney scale, Slaney normalization — librosa.filters.mel
parity), counterpart of ``flowhigh_tpu/dsp/mel.py``. The basis is designed
once in numpy and applied as one [n_mels, bins] x [bins, T] matmul."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import device_constant

_F_SP = 200.0 / 3.0  # Slaney: Hz per mel below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 48000, n_fft: int = 2048, n_mels: int = 256,
                   fmin: float = 20.0, fmax: float = 24000.0) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] float32 triangular filterbank (librosa parity)."""
    fmax = float(fmax if fmax is not None else sr / 2)
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])  # Slaney area norm
    return (weights * enorm[:, None]).astype(np.float32)


def apply_mel(spec_mag: torch.Tensor, basis: np.ndarray) -> torch.Tensor:
    """[..., bins, T] magnitude -> [..., n_mels, T] mel spectrogram, one
    [n_mels, bins] x [bins, T] product per row: a batched product may sum
    in another order than a single one (cuBLAS picks its algorithm by the
    batch), and a clip's mel must not depend on the batch it rides in."""
    b = device_constant(basis, spec_mag.device)
    rows = spec_mag.reshape((-1,) + spec_mag.shape[-2:])
    out = torch.stack([torch.matmul(b, r) for r in rows])
    return out.reshape(spec_mag.shape[:-2] + out.shape[-2:])


def log_compress(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """Dynamic-range compression log(clamp(x, 1e-5))."""
    return torch.log(torch.clamp(x, min=clip_val))
