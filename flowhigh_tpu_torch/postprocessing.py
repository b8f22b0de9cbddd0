"""Spectral post-processing that keeps the source's low band — counterpart
of ``post_process`` and ``post_process_with_phase`` in
``flowhigh_tpu/postprocessing.py``.

STFT both waveforms (center=True, zero padding), find the source's
cumulative-energy cutoff bin (>= 99% threshold), splice source bins below
the cutoff into the prediction's spectrum (the phase variant: the
prediction's magnitude with the source's low-band phase tiled upward),
iSTFT back at ``length`` and peak-normalize to 0.99.
"""

from __future__ import annotations

import torch

from .cfm import cutoff_bins_from_energy
from .dsp import istft, stft


def post_process(pred: torch.Tensor, src: torch.Tensor, length: int,
                 n_fft: int = 2048, hop_length: int = 480,
                 threshold: float = 0.99) -> torch.Tensor:
    """pred, src: [B, T] 48 kHz waveforms -> [B, length]."""
    spec_pred = stft(pred, n_fft, hop_length, n_fft, center=True,
                     pad_mode="constant")
    spec_src = stft(src, n_fft, hop_length, n_fft, center=True,
                    pad_mode="constant")
    t = min(spec_pred.shape[-1], spec_src.shape[-1])
    spec_pred, spec_src = spec_pred[..., :t], spec_src[..., :t]

    energy = torch.sum(torch.abs(spec_src), dim=-1)      # [B, bins]
    cr = cutoff_bins_from_energy(energy, threshold)      # [B]
    bins = torch.arange(spec_pred.shape[-2], device=pred.device)
    take_pred = bins[None, :, None] >= cr[:, None, None]
    spec_out = torch.where(take_pred, spec_pred, spec_src)

    audio = istft(spec_out, n_fft, hop_length, n_fft, length=length)
    peak = torch.amax(torch.abs(audio), dim=-1, keepdim=True)
    return audio / torch.clamp(peak, min=1e-8) * 0.99


def post_process_with_phase(pred: torch.Tensor, src: torch.Tensor,
                            length: int, n_fft: int = 2048,
                            hop_length: int = 480,
                            threshold: float = 0.99) -> torch.Tensor:
    """The phase-replication variant, pred, src: [B, T] -> [B, length]:
    above the cutoff (clamped to >= 1) the prediction's magnitude with the
    phase of source row ``(b - bins) mod cutoff``, the reference's repeat
    and slice of the low-band phase rows as a gather. The modulo is a
    floor modulo (``torch.remainder``, as ``jnp.mod``): its operands are
    negative, where ``torch.fmod`` would differ in sign."""
    spec_pred = stft(pred, n_fft, hop_length, n_fft, center=True,
                     pad_mode="constant")
    spec_src = stft(src, n_fft, hop_length, n_fft, center=True,
                    pad_mode="constant")
    t = min(spec_pred.shape[-1], spec_src.shape[-1])
    spec_pred, spec_src = spec_pred[..., :t], spec_src[..., :t]

    energy = torch.sum(torch.abs(spec_src), dim=-1)
    cr = torch.clamp(cutoff_bins_from_energy(energy, threshold), min=1)  # [B]
    bins = spec_pred.shape[-2]
    b_idx = torch.arange(bins, device=pred.device)
    src_row = torch.remainder(b_idx[None, :] - bins, cr[:, None])  # [B, bins]
    phase = torch.angle(spec_src)
    rep_phase = torch.gather(phase, 1, src_row[..., None].expand(-1, -1, t))
    high = torch.polar(torch.abs(spec_pred), rep_phase)
    spec_out = torch.where(b_idx[None, :, None] >= cr[:, None, None], high,
                           spec_src)

    audio = istft(spec_out, n_fft, hop_length, n_fft, length=length)
    peak = torch.amax(torch.abs(audio), dim=-1, keepdim=True)
    return audio / torch.clamp(peak, min=1e-8) * 0.99
