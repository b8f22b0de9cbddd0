"""The signal processing around the models, in plain NumPy / SciPy and
PyTorch, float64.

- ``upsample``: ``scipy.signal.resample_poly`` (the reference's own call,
  flowhighsr.py:68), on the host;
- ``log_mel``: the mel codec's encoder (melvoco.py): reflect padding of
  (n_fft - hop) / 2 a side, frames of n_fft every hop under a periodic Hann
  window, |STFT| as sqrt(re^2 + im^2 + 1e-9), the Slaney-scale filterbank
  with Slaney area normalisation (librosa's ``filters.mel``), and
  log(max(., 1e-5));
- ``splice``: the post-processing of postprocessing.py: both waves through
  a centred, zero-padded STFT, the source's bins below its 99% cumulative
  energy bin put under the prediction's, the inverse STFT by windowed
  overlap-add over the window's squared envelope, and a peak of 0.99.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch


def upsample(x: np.ndarray, target_sr: int, in_sr: int) -> np.ndarray:
    g = math.gcd(target_sr, in_sr)
    return scipy.signal.resample_poly(x.astype(np.float64), target_sr // g,
                                      in_sr // g)


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """[n_mels, n_fft / 2 + 1] Slaney filterbank, area-normalised."""
    freqs = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rise = (freqs[None, :] - lo) / (mid - lo)
    fall = (hi - freqs[None, :]) / (hi - mid)
    tri = np.maximum(0.0, np.minimum(rise, fall))
    return tri * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def _hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / n)


def log_mel(wave: torch.Tensor, mel: dict) -> torch.Tensor:
    """[B, T] -> [B, frames, n_mels] float64. ``mel``: the configuration's
    ``mel`` group."""
    n_fft, hop = mel["n_fft"], mel["hop_length"]
    x = wave.double()
    pad = (n_fft - hop) // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * _hann(mel["win_length"], x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(mel_basis(mel["sampling_rate"], n_fft,
                                       mel["n_mels"], mel["f_min"],
                                       mel["f_max"])).to(x.device)
    return torch.log(torch.clamp(mag @ basis.T, min=1e-5))


def _stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[T] -> [frames, bins], centred, zero padding."""
    x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2))
    return torch.fft.rfft(x.unfold(-1, n_fft, hop) * _hann(n_fft, x.device),
                          dim=-1)


def _istft(spec: torch.Tensor, n_fft: int, hop: int,
           length: int) -> torch.Tensor:
    win = _hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    n = frames.shape[0]
    total = n_fft + hop * (n - 1)
    sig = torch.zeros(total, dtype=torch.float64, device=spec.device)
    env = torch.zeros_like(sig)
    for i in range(n):
        sig[i * hop:i * hop + n_fft] += frames[i]
        env[i * hop:i * hop + n_fft] += win * win
    sig, env = sig[n_fft // 2:], env[n_fft // 2:]
    sig = torch.where(env > 1e-11, sig / env, sig)[:length]
    return torch.nn.functional.pad(sig, (0, length - sig.shape[0]))


def cutoff_bins(energy: torch.Tensor, share: float) -> int:
    """The last bin whose cumulative energy stays below ``share`` of the
    whole, less one, and at least 0 (postprocessing.py's rule)."""
    csum = torch.cumsum(energy, dim=0)
    return max(int(torch.sum(csum < csum[-1] * share)) - 1, 0)


def splice(pred: torch.Tensor, src: torch.Tensor, length: int,
           n_fft: int = 2048, hop: int = 480, share: float = 0.99,
           margin: float = 0.0) -> list:
    """pred, src [T] -> the spliced [length] waves, peak 0.99: one, or one
    per cutoff bin that a relative change of ``margin`` in the energy
    threshold reaches (the decision a program computing in float32 may take
    either way)."""
    sp, ss = _stft(pred.double(), n_fft, hop), _stft(src.double(), n_fft, hop)
    t = min(sp.shape[0], ss.shape[0])
    sp, ss = sp[:t], ss[:t]
    energy = torch.sum(torch.abs(ss), dim=0)
    lo = cutoff_bins(energy, share * (1 - margin))
    hi = cutoff_bins(energy, min(share * (1 + margin), 1.0))
    outs = []
    bins = torch.arange(sp.shape[1], device=sp.device)
    for cr in range(lo, hi + 1):
        spec = torch.where(bins[None, :] >= cr, sp, ss)
        wave = _istft(spec, n_fft, hop, length)
        outs.append(wave / torch.clamp(wave.abs().max(), min=1e-8) * 0.99)
    return outs
