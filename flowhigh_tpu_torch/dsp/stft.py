"""STFT / iSTFT — counterpart of ``flowhigh_tpu/dsp/stft.py``.

Two framing conventions are used by the pipeline:

- ``center=False`` with explicit reflect pre-padding of ``(n_fft - hop) // 2``
  per side — the mel-codec frontend convention;
- ``center=True`` with ``n_fft // 2`` padding in ``pad_mode`` (``constant``
  for the spectral post-processing, torchaudio's Spectrogram default).

Both run through ``torch.stft``/``torch.istft`` (cuFFT on the card) with a
periodic Hann window, in float32, or in float64 for float64 input. The
forward STFT also takes ``window="rect"``: ones of ``win_length``, what
``torch.stft`` uses when given no window (the reference MRD's
spectrogram).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _hann(win_length: int, like: torch.Tensor) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, device=like.device,
                             dtype=like.dtype)


def _window(window: str, win_length: int, like: torch.Tensor) -> torch.Tensor:
    """The analysis window of ``win_length``; ``torch.stft`` centres it in
    the frame with ``(n_fft - win_length) // 2`` zeros on the left, as the
    JAX package pads its window."""
    if window == "hann":
        return _hann(win_length, like)
    if window == "rect":
        return torch.ones(win_length, device=like.device, dtype=like.dtype)
    raise ValueError(f"unsupported window: {window!r}")


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window, the JAX package's: computed in float64 with
    numpy, then cast to ``dtype``."""
    n = np.arange(win_length)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def num_frames(n_samples: int, n_fft: int, hop_length: int,
               center: bool) -> int:
    """Frame count of an STFT over ``n_samples``."""
    if center:
        n_samples = n_samples + 2 * (n_fft // 2)
    return 1 + (n_samples - n_fft) // hop_length


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """[..., T] -> [..., F, frame_length] overlapping frames (no padding),
    a strided view of ``x``."""
    return x.unfold(-1, frame_length, hop_length)


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
         win_length: int | None = None, center: bool = True,
         pad_mode: str = "reflect", window: str = "hann") -> torch.Tensor:
    """Complex STFT [..., T] -> [..., n_fft//2 + 1, frames] (onesided).

    ``center=False`` applies melvoco-style reflect padding of
    ``(n_fft - hop) // 2`` per side first; ``center=True`` pads ``n_fft // 2``
    with ``pad_mode``. ``window``: "hann" (periodic) or "rect". Runs in
    float64 for float64 input, else float32."""
    if win_length is None:
        win_length = n_fft
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if x.dtype != torch.float64:
        x = x.float()
    pad = n_fft // 2 if center else (n_fft - hop_length) // 2
    x = F.pad(x[:, None, :], (pad, pad), mode=pad_mode)[:, 0, :]
    spec = torch.stft(x, n_fft, hop_length, win_length,
                      window=_window(window, win_length, x),
                      center=False, return_complex=True)
    return spec.reshape(batch_shape + spec.shape[-2:])


def stft_magnitude(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
                   win_length: int | None = None, center: bool = True,
                   pad_mode: str = "reflect", eps: float = 0.0,
                   window: str = "hann") -> torch.Tensor:
    spec = stft(x, n_fft, hop_length, win_length, center, pad_mode, window)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 480,
          win_length: int | None = None,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT, ``center=True`` convention, torch.istft semantics:
    windowed overlap-add over the window-square envelope, the front center
    padding trimmed, the result cut or zero-padded to ``length``.

    Written out (irfft, ``F.fold`` overlap-add) rather than calling
    ``torch.istft``, whose envelope check reads a value back to the host:
    on the card that would stall the thread that dispatches a clip until
    the device caught up. Samples where the envelope is below 1e-11 (none
    for a Hann window at this hop) are left undivided instead of raising."""
    if win_length is None:
        win_length = n_fft
    batch_shape = spec.shape[:-2]
    spec = spec.reshape((-1,) + spec.shape[-2:])
    n_frames = spec.shape[-1]
    window = _hann(win_length, spec.real)
    if win_length < n_fft:  # centred in the frame, as torch.istft pads it
        left = (n_fft - win_length) // 2
        window = F.pad(window, (left, n_fft - win_length - left))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-2) * window[:, None]
    total = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        return F.fold(cols, output_size=(1, total), kernel_size=(1, n_fft),
                      stride=(1, hop_length))[:, 0, 0, :]

    env = overlap_add((window * window)[None, :, None].expand(
        1, n_fft, n_frames))
    sig = overlap_add(frames)
    start = n_fft // 2
    end = start + length if length is not None else total - n_fft // 2
    sig, env = sig[:, start:min(end, total)], env[:, start:min(end, total)]
    sig = torch.where(env > 1e-11, sig / env, sig)
    if end > total:
        sig = F.pad(sig, (0, end - total))
    return sig.reshape(batch_shape + sig.shape[-1:])
