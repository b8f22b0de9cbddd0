"""Seeded inputs, made on the device.

- ``speech``: speech-like clips. A voiced source whose pitch glides around a
  base of ``f0`` Hz, every harmonic below ``top_hz`` weighted 1 / k and
  raised near two formants, under a syllable-rate envelope, plus white noise
  ``noise_db`` below the voiced part's RMS, at a peak drawn in ``peak``.
- ``tones``: the training waves of the field's trainer (four tones and
  noise at 48 kHz, zero past a length drawn in ``seconds``) with their
  band-limited conditions (every bin above a cutoff drawn in ``cutoff_hz``
  zeroed).

A mix's sizes are a fixed set that the seed only reorders (``lengths``,
``gaps``), so that every seed brings the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lengths(n: int, lo: float, hi: float, rate: int,
            rng: np.random.Generator) -> list:
    """``n`` clip lengths in samples, evenly spread over [lo, hi] seconds,
    in an order drawn from ``rng``."""
    secs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return [int(round(s * rate)) for s in rng.permutation(secs)]


def gaps(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` gaps between Poisson arrivals at ``rate`` a second: the
    exponential distribution's quantiles at (i + 0.5) / n, in an order drawn
    from ``rng``."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)


def speech(n: int, sr: int, spec: dict, gen: torch.Generator,
           device) -> torch.Tensor:
    """One speech-like clip of ``n`` samples at ``sr``, float32 [n]."""
    f64 = dict(dtype=torch.float64, device=device)

    def u(lo, hi):
        return lo + (hi - lo) * float(torch.rand((), generator=gen, **f64))

    t = torch.arange(n, **f64) / sr
    f0 = u(*spec["f0"]) * (1 + 0.08 * torch.sin(2 * math.pi * u(0.2, 0.7) * t
                                                + u(0, 6.3))
                           + 0.03 * torch.sin(2 * math.pi * u(4, 7) * t))
    phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
    f1, f2 = u(300, 900), u(900, 2500)
    wave = torch.zeros(n, **f64)
    for k in range(1, int(spec["top_hz"] / spec["f0"][0]) + 1):
        fk = k * f0
        amp = (1.0 / k) * (1 + 3 * torch.exp(-((fk - f1) / 250) ** 2)
                           + 2 * torch.exp(-((fk - f2) / 400) ** 2))
        amp = torch.where(fk < spec["top_hz"], amp, 0.0)
        wave += amp * torch.sin(k * phase + u(0, 6.3))
    syl = u(*spec["syllable_hz"])
    env = (0.5 * (1 + torch.sin(2 * math.pi * syl * t + u(0, 6.3)))) ** 1.5
    wave = wave * (0.15 + env)
    rms = torch.sqrt(torch.mean(wave ** 2))
    wave += rms * 10 ** (spec["noise_db"] / 20) * torch.randn(
        n, generator=gen, **f64)
    wave *= u(*spec["peak"]) / wave.abs().max()
    return wave.float()


def speech_pool(sizes: list, sr: int, spec: dict, seed: int,
                device) -> list:
    """Clips of the given sizes as float32 numpy arrays (the served path
    takes host audio)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [speech(n, sr, spec, gen, device).cpu().numpy() for n in sizes]


def tones(b: int, seconds, cutoff_hz, seed: int, device,
          sr: int = 48000) -> dict:
    """``b`` waves at ``sr`` padded to ``seconds[1]``, valid lengths uniform
    in ``seconds``: four tones and noise, zero past the length; the
    condition is the wave with every bin above a cutoff uniform in
    ``cutoff_hz`` zeroed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    f64 = dict(dtype=torch.float64, **kw)
    n = int(seconds[1] * sr)
    lens = torch.randint(int(seconds[0] * sr), n + 1, (b,), **kw)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    freqs = 100.0 + 19900.0 * torch.rand(b, 4, 1, **f64)
    wave = (0.1 * torch.sin(2 * math.pi * freqs * t).sum(1)
            + 0.02 * torch.randn(b, n, **f64))
    wave = torch.where(torch.arange(n, device=device)[None, :]
                       < lens[:, None], wave, 0.0)
    spec = torch.fft.rfft(wave)
    lo, hi = cutoff_hz
    cut = lo + (hi - lo) * torch.rand(b, 1, **f64)
    freq = torch.fft.rfftfreq(n, 1 / sr, device=device, dtype=torch.float64)
    cond = torch.fft.irfft(torch.where(freq[None, :] > cut, 0.0, spec), n)
    return {"wave": wave.float(), "cond": cond.float(), "lengths": lens}
