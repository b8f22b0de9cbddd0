"""Mel codec: waveform -> 256-band log-mel, and mel -> waveform via BigVGAN
— counterpart of ``flowhigh_tpu/models/melvoco.py``.

``encode``: reflect pad (n_fft - hop) / 2, center=False STFT,
sqrt(re^2 + im^2 + 1e-9) magnitude, Slaney mel matmul, log-clamp 1e-5.
``encode_torchaudio``: the reference's alternative encode (nothing in the
reference's pipeline calls it, but it is part of the ``MelVoco`` surface):
a center=True reflect STFT, the power spectrum, the HTK mel bank without
normalization and, when ``log``, 10 log10(clamp(., 1e-10)). Its mel is
not interchangeable with ``encode``'s, in the reference too. ``MelVoco``
pairs the mel config with a ``BigVGAN`` module whose ``decode`` runs the
port's kernels on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import MelConfig, VocoderConfig
from ..dsp import (apply_mel, log_compress, mel_filterbank, mel_filterbank_htk,
                   stft, stft_magnitude)
from ..ops.quant import check_lowering_switches, resolve_conv_dtype
from ..utils import resolve_device
from .bigvgan import BigVGAN


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


def encode_torchaudio(audio: torch.Tensor, cfg: MelConfig = MelConfig(),
                      log: bool = True) -> torch.Tensor:
    """[B, T] -> [B, frames, n_mels] float32: torchaudio's defaults
    (``T.Spectrogram``: center=True reflect STFT, power 2; ``T.MelScale``:
    HTK bank with f_min 0, no normalization; ``AmplitudeToDB`` on power:
    10 log10, amin 1e-10, no top_db, when ``log``).

    The power spectrum is taken in float64, as ``encode``'s magnitude, for
    the same reason: near the 1e-10 clamp a float32 FFT's rounding decides
    the decibels, and cuFFT's differs from the CPU FFT's
    (chip_smoke.py phase S4 prints the card against the CPU both ways)."""
    spec = stft(audio.double(), cfg.n_fft, cfg.hop_length, cfg.win_length,
                center=True, pad_mode="reflect")
    power = (spec.real ** 2 + spec.imag ** 2).float()
    basis = mel_filterbank_htk(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                               0.0, cfg.f_max)
    mel = apply_mel(power, basis)
    if log:
        mel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return mel.transpose(-1, -2)


class MelVoco:
    """The reference's ``MelVoco`` surface (``n_mels``, ``sampling_rate``,
    ``hop_length``, ``win_length``, ``latent_dim``; ``encode``,
    ``encode_torchaudio``, ``decode``) over a ``BigVGAN`` module on
    ``device`` (CUDA unless ``device="cpu"``).

    ``mel_cfg`` / ``voc_cfg`` are the configs; without them the reference's
    keywords build them (``n_mels`` ... ``hop_length``; ``vocoder_config``
    a vocoder JSON path). Weights: ``vocoder_params``, the JAX package's
    param tree, or ``vocoder_path``, a reference generator file
    (``{'generator': state dict}`` or the state dict itself, weight norm
    folded on load); else the module's constructor init until
    ``init_vocoder_params``. ``conv_dtype`` (None | torch.bfloat16 |
    torch.int8 | "bfloat16" | "int8") and ``fuse_act_conv`` (False, the
    JAX package's default here: kernels A and B | True | "auto" |
    "pairs") go to ``BigVGAN``. ``dtype`` must be float32, the port's only
    compute dtype; ``storage_dtype`` is not ported (ROADMAP.md queue 1
    item 15). ``fused_act``, ``packed``, ``pallas_convs`` and
    ``kernel_pipeline`` are the JAX package's TPU lowering switches:
    validated, and without effect on the card."""

    def __init__(self, mel_cfg: Optional[MelConfig] = None,
                 voc_cfg: Optional[VocoderConfig] = None,
                 vocoder_params=None, dtype=torch.float32,
                 fused_act: bool = False, packed: bool = False,
                 conv_dtype=None, pallas_convs: bool = False,
                 storage_dtype=None, fuse_act_conv=False,
                 kernel_pipeline: int = 1, *, n_mels=None, sampling_rate=None,
                 f_max=None, f_min=None, n_fft=None, win_length=None,
                 hop_length=None, vocoder="bigvgan", vocoder_config=None,
                 vocoder_path=None, log=True, device=None):
        check_lowering_switches(fused_act, packed, kernel_pipeline,
                                ("fused_act", "packed", "kernel_pipeline"))
        if not isinstance(pallas_convs, bool):
            raise ValueError(f"pallas_convs must be a bool, got "
                             f"{pallas_convs!r}")
        if dtype not in (torch.float32, "float32"):
            raise ValueError(f"dtype must be float32, got {dtype!r}")
        if storage_dtype is not None:
            raise NotImplementedError(
                "storage_dtype (bf16 feature maps through kernels A-E) is "
                "not ported (ROADMAP.md queue 1 item 15)")
        if vocoder != "bigvgan":
            raise ValueError(f"unsuitable vocoder name {vocoder!r}")
        if mel_cfg is None:
            base = MelConfig()
            mel_cfg = MelConfig(
                n_mels=n_mels or base.n_mels,
                sampling_rate=sampling_rate or base.sampling_rate,
                f_max=f_max or base.f_max, f_min=f_min or base.f_min,
                n_fft=n_fft or base.n_fft,
                win_length=win_length or base.win_length,
                hop_length=hop_length or base.hop_length)
        if voc_cfg is None:
            if vocoder_config is not None:
                from ..compat.torch_ckpt import vocoder_config_from_json
                voc_cfg = vocoder_config_from_json(vocoder_config)
            else:
                voc_cfg = VocoderConfig()
        self.mel_cfg, self.voc_cfg, self.log = mel_cfg, voc_cfg, log
        self.device = resolve_device(device)
        self.vocoder = BigVGAN(voc_cfg, fuse_act_conv,
                               resolve_conv_dtype(conv_dtype)).eval()
        if vocoder_params is not None:
            from ..compat.jax_params import vocoder_state_from_jax
            self.vocoder.load_state_dict(
                vocoder_state_from_jax(vocoder_params, voc_cfg))
        elif vocoder_path is not None:
            from ..compat.torch_ckpt import vocoder_state_from_reference
            pkg = torch.load(vocoder_path, map_location="cpu",
                             weights_only=True)
            self.vocoder.load_state_dict(vocoder_state_from_reference(
                pkg.get("generator", pkg), self.vocoder.state_dict()))
        self.vocoder.to(self.device)

    # the reference's attribute surface
    @property
    def n_mels(self) -> int:
        return self.mel_cfg.n_mels

    @property
    def sampling_rate(self) -> int:
        return self.mel_cfg.sampling_rate

    @property
    def hop_length(self) -> int:
        return self.mel_cfg.hop_length

    @property
    def win_length(self) -> int:
        return self.mel_cfg.win_length

    @property
    def latent_dim(self) -> int:
        return self.mel_cfg.n_mels

    def init_vocoder_params(self, seed: int = 0) -> None:
        """Seeded init of the vocoder (``compat.jax_params.seeded_init_``)
        for runs without a checkpoint."""
        from ..compat.jax_params import seeded_init_
        seeded_init_(self.vocoder, seed)

    def _audio(self, audio) -> torch.Tensor:
        return torch.as_tensor(audio, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """[B, T] waveform -> [B, frames, n_mels] log-mel on the device."""
        return encode(self._audio(audio), self.mel_cfg)

    @torch.inference_mode()
    def encode_torchaudio(self, audio) -> torch.Tensor:
        """[B, T] waveform -> [B, frames, n_mels] (``encode_torchaudio``)."""
        return encode_torchaudio(self._audio(audio), self.mel_cfg, self.log)

    @torch.inference_mode()
    def decode(self, mel) -> torch.Tensor:
        """[B, frames, n_mels] -> [B, frames * hop] waveform on the device."""
        return self.vocoder(self._audio(mel))
