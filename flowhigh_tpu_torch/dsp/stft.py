"""STFT / iSTFT — counterpart of ``flowhigh_tpu/dsp/stft.py``.

Two framing conventions are used by the pipeline:

- ``center=False`` with explicit reflect pre-padding of ``(n_fft - hop) // 2``
  per side — the mel-codec frontend convention;
- ``center=True`` with ``n_fft // 2`` padding in ``pad_mode`` (``constant``
  for the spectral post-processing, torchaudio's Spectrogram default).

Both run through ``torch.stft``/``torch.istft`` (cuFFT on the card) with a
periodic Hann window, in float32, or in float64 for float64 input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _hann(win_length: int, like: torch.Tensor) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, device=like.device,
                             dtype=like.dtype)


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
         win_length: int | None = None, center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT [..., T] -> [..., n_fft//2 + 1, frames] (onesided).

    ``center=False`` applies melvoco-style reflect padding of
    ``(n_fft - hop) // 2`` per side first; ``center=True`` pads ``n_fft // 2``
    with ``pad_mode``. Runs in float64 for float64 input, else float32."""
    if win_length is None:
        win_length = n_fft
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if x.dtype != torch.float64:
        x = x.float()
    pad = n_fft // 2 if center else (n_fft - hop_length) // 2
    x = F.pad(x[:, None, :], (pad, pad), mode=pad_mode)[:, 0, :]
    spec = torch.stft(x, n_fft, hop_length, win_length,
                      window=_hann(win_length, x),
                      center=False, return_complex=True)
    return spec.reshape(batch_shape + spec.shape[-2:])


def stft_magnitude(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
                   win_length: int | None = None, center: bool = True,
                   pad_mode: str = "reflect",
                   eps: float = 0.0) -> torch.Tensor:
    spec = stft(x, n_fft, hop_length, win_length, center, pad_mode)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
          win_length: int | None = None,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT, ``center=True`` convention, torch.istft semantics:
    windowed overlap-add over the window-square envelope, the front center
    padding trimmed, the result cut or zero-padded to ``length``."""
    if win_length is None:
        win_length = n_fft
    batch_shape = spec.shape[:-2]
    spec = spec.reshape((-1,) + spec.shape[-2:])
    sig = torch.istft(spec, n_fft, hop_length, win_length,
                      window=_hann(win_length, spec.real),
                      center=True, length=length)
    return sig.reshape(batch_shape + sig.shape[-1:])
