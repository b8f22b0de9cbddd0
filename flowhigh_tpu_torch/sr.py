"""FlowHighSR — any-rate -> 48 kHz super-resolution, counterpart of the
``generate`` surface of ``flowhigh_tpu/sr.py``.

One clip runs: polyphase upsample, masked peak-norm, mel encode, cutoff
search, prior, fixed-grid ODE solve of the vector field, BigVGAN vocode
(the port's CUDA kernels on the card), spectral low-band splice. Audio is
bucketed to 1 s multiples at 48 kHz as in the JAX package, so both see the
same padded shapes; the result is sliced back to the true length.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .cfm import mel_cutoff_bins, odeint_fixed, sample_prior
from .compat.jax_params import (seeded_init_, vector_field_state_from_jax,
                                vocoder_state_from_jax)
from .config import CFMConfig, FlowHighConfig
from .dsp import resample_poly
from .models import BigVGAN, VectorFieldNet, forward_with_cond_scale, mel_encode
from .postprocessing import post_process
from .utils import resolve_device

BUCKET_SAMPLES = 48000  # 1 s @ 48 kHz — the length bucket


class FlowHighSR:
    def __init__(self, config: FlowHighConfig = FlowHighConfig(), params=None,
                 vocoder_params=None, *, cfm_method: Optional[str] = None,
                 sigma: Optional[float] = None,
                 ode_method: Optional[str] = None,
                 prior_semantics: str = "reference",
                 upsampling_method: str = "scipy", device=None):
        """``params``/``vocoder_params``: the JAX package's param trees
        (nested dicts of arrays), carried across by ``compat.jax_params``;
        without them the networks keep their constructor init until
        ``init_params``. ``device=None`` means CUDA, and raises without it."""
        self.config = config
        self.device = resolve_device(device)
        self.cfm_method = cfm_method or config.cfm.cfm_method
        if self.cfm_method not in CFMConfig.CFM_METHODS:
            raise ValueError(f"unknown cfm_method {self.cfm_method!r}")
        self.sigma = config.cfm.sigma if sigma is None else sigma
        self.ode_method = ode_method or config.cfm.ode_method
        if self.ode_method == "adaptive":
            raise NotImplementedError("the adaptive ODE solver is not ported")
        if self.ode_method not in ("euler", "midpoint"):
            raise ValueError(f"unknown ode_method {self.ode_method!r}")
        if upsampling_method == "librosa":
            raise NotImplementedError("the soxr_hq (librosa) upsampler is not ported")
        if upsampling_method != "scipy":
            raise ValueError(f"upsampling_method must be 'scipy' or 'librosa', "
                             f"got {upsampling_method!r}")
        if prior_semantics == "paper":
            raise NotImplementedError("prior_semantics='paper' is not ported")
        if prior_semantics != "reference":
            raise ValueError(f"prior_semantics must be 'reference' or 'paper', "
                             f"got {prior_semantics!r}")

        self.net = VectorFieldNet(config.model).eval()
        self.vocoder = BigVGAN(config.vocoder).eval()
        if params is not None:
            self.net.load_state_dict(
                vector_field_state_from_jax(params, config.model))
        if vocoder_params is not None:
            self.vocoder.load_state_dict(
                vocoder_state_from_jax(vocoder_params, config.vocoder))
        self.net.to(self.device)
        self.vocoder.to(self.device)

    def init_params(self, seed: int = 0) -> None:
        """Seeded init of both networks (``compat.jax_params.seeded_init_``)
        for runs without a checkpoint."""
        seeded_init_(self.net, seed)
        seeded_init_(self.vocoder, seed + 1)

    def _default_stds(self):
        """(std_1, std_2) of the prior: the reference's executed behaviour,
        ``(1.0, sigma)`` for every method (see the JAX package's
        ``FlowHighSR._default_stds``)."""
        return 1.0, self.sigma

    # -- the clip pipeline ------------------------------------------------------

    def _prep_and_solve(self, audio: torch.Tensor, n_valid: int,
                        generator: torch.Generator, in_sr: int, target_sr: int,
                        time_steps: int):
        """Upsample + peak-norm + mel encode + cutoff + prior + ODE solve.
        Returns (sampled mel [B, F, M], cond wav [B, T48], n_valid48)."""
        hop = self.config.mel.hop_length
        cond = resample_poly(audio, target_sr, in_sr)  # [B, T48_pad]
        # exact floor(n * up / down) without overflow
        g = math.gcd(target_sr, in_sr)
        up, down = target_sr // g, in_sr // g
        q, r = divmod(n_valid, down)
        n_valid48 = q * up + r * up // down

        t48 = cond.shape[-1]
        valid = torch.arange(t48, device=cond.device)[None, :] < n_valid48
        cond = torch.where(valid, cond, torch.zeros((), device=cond.device))
        peak = torch.amax(torch.abs(cond), dim=-1, keepdim=True)
        cond = cond / torch.clamp(peak, min=1e-8)  # silence-safe

        cond_mel = mel_encode(cond, self.config.mel)     # [B, F, 256]
        n_frames = cond_mel.shape[1]
        frame_mask = (torch.arange(n_frames, device=cond.device)[None, :]
                      < (n_valid48 + hop - 1) // hop)
        frame_mask = frame_mask.expand(cond.shape[0], -1)
        cutoff = mel_cutoff_bins(cond_mel)

        def ode_fn(t, x):
            return forward_with_cond_scale(self.net, x, times=t, cond=cond_mel,
                                           cond_scale=1.0, mask=frame_mask)

        std_1, std_2 = self._default_stds()
        y0 = sample_prior(generator, self.cfm_method, cond_mel, std_1, std_2,
                          cutoff)
        sampled = odeint_fixed(ode_fn, y0, time_steps, self.ode_method)
        return sampled, cond, n_valid48

    def _align_and_splice(self, hr: torch.Tensor, cond: torch.Tensor,
                          n_valid48: int) -> torch.Tensor:
        """Length-align the vocoded audio with the upsampled source, zero the
        padding, and run the spectral low-band splice."""
        t_out = min(hr.shape[-1], cond.shape[-1])
        keep = torch.arange(t_out, device=hr.device)[None, :] < n_valid48
        hr = torch.where(keep, hr[..., :t_out], torch.zeros((), device=hr.device))
        return post_process(hr, cond[..., :t_out], t_out)

    def _generate_impl(self, audio: torch.Tensor, n_valid: int,
                       generator: torch.Generator, in_sr: int, target_sr: int,
                       time_steps: int):
        sampled, cond, n_valid48 = self._prep_and_solve(
            audio, n_valid, generator, in_sr, target_sr, time_steps)
        hr = self.vocoder(sampled)                     # [B, F * hop]
        return self._align_and_splice(hr, cond, n_valid48), n_valid48

    @torch.inference_mode()
    def generate(self, audio: np.ndarray, sr: int,
                 target_sampling_rate: int = 48000, timestep: int = 1,
                 seed: int = 0) -> np.ndarray:
        """[T] or [1, T] numpy waveform at ``sr`` -> [1, T'] at 48 kHz.

        int16 input is PCM scale: its samples go to the device as int16 and
        are divided by 32768 there, bit-identical to passing float (int16 is
        exact in float32 and /32768 is a power of two). Float input with
        |max| > 1 is taken as int16 scale too."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio[0]
        int16_in = audio.dtype == np.int16
        if not int16_in and np.abs(audio).max() > 1:
            audio = audio / 32768.0

        n = len(audio)
        in_bucket = BUCKET_SAMPLES * sr // target_sampling_rate
        n_pad = max(in_bucket, math.ceil(n / in_bucket) * in_bucket)
        padded = np.zeros(n_pad, dtype=np.int16 if int16_in else np.float32)
        padded[:n] = audio

        x = torch.from_numpy(padded)[None, :].to(self.device)
        if int16_in:
            x = x.to(torch.float32) / 32768.0
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out, n48 = self._generate_impl(x, n, generator, int(sr),
                                       int(target_sampling_rate), int(timestep))
        return out[:, :n48].cpu().numpy()
