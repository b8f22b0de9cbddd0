"""FlowHighSR — any-rate -> 48 kHz super-resolution, counterpart of the
``generate`` / ``generate_batch`` / ``dispatch_generate`` /
``generate_longform`` / ``vocode_chunked`` / ``from_local`` /
``from_pretrained`` surface of ``flowhigh_tpu/sr.py``.

One clip runs: polyphase upsample, masked peak-norm, mel encode, cutoff
search, prior, fixed-grid ODE solve of the vector field, BigVGAN vocode
(the port's CUDA kernels on the card), spectral low-band splice. Audio is
bucketed to 1 s multiples at 48 kHz as in the JAX package, so both see the
same padded shapes; the result is sliced back to the true length.

``_generate_impl`` reads nothing back from the device: the true lengths go
in as a tensor, the output length is computed on the host from the same
integers (``valid_samples_48k``), so a caller can keep several clips in
flight (``serving.ServingPipeline``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .cfm import mel_cutoff_bins, odeint_fixed, sample_prior
from .compat.jax_params import (seeded_init_, vector_field_state_from_jax,
                                vocoder_state_from_jax)
from .config import CFMConfig, FlowHighConfig, ModelConfig
from .dsp import resample_poly
from .models import BigVGAN, VectorFieldNet, forward_with_cond_scale, mel_encode
from .postprocessing import post_process
from .utils import resolve_device

BUCKET_SAMPLES = 48000  # 1 s @ 48 kHz — the length bucket


def _rates(target_sr: int, in_sr: int) -> tuple[int, int]:
    g = math.gcd(target_sr, in_sr)
    return target_sr // g, in_sr // g


def valid_samples_48k(n: int, in_sr: int, target_sr: int = 48000) -> int:
    """floor(n * target_sr / in_sr): the output samples of ``n`` input
    samples (the host-side twin of ``_prep_and_solve``'s ``n_valid48``)."""
    up, down = _rates(target_sr, in_sr)
    q, r = divmod(n, down)
    return q * up + r * up // down


def padded_length(n: int, in_sr: int, target_sr: int = 48000) -> int:
    """Input samples after bucketing ``n`` so that the output lands on 1 s
    multiples; raises for a rate too low to fill one bucket sample."""
    in_bucket = BUCKET_SAMPLES * in_sr // target_sr
    if in_bucket <= 0:
        raise ValueError(f"input rate {in_sr} too low for target {target_sr}")
    return max(in_bucket, math.ceil(n / in_bucket) * in_bucket)


def _wire_int16(out: torch.Tensor) -> torch.Tensor:
    """Waveform -> int16 on the device, round(clip(x * 32767)) (the
    reference's wav scale), so the device-to-host copy moves half the bytes.
    The splice ends in a x0.99 peak-norm, so for outputs of ``generate`` the
    clip never engages and the error is pure quantisation (<= 0.5 / 32767
    per sample)."""
    return torch.clamp(torch.round(out * 32767.0), -32768.0,
                       32767.0).to(torch.int16)


def prepare_clip(audio) -> np.ndarray:
    """[T] or [1, T] waveform -> 1-D float32, or int16 kept as int16 (PCM
    scale, /32768 on the device); float input with |max| > 1 is taken as
    int16 scale and divided by 32768 here (the reference's convention)."""
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio[0]
    if audio.ndim != 1:
        raise ValueError(f"audio must be [T] or [1, T], got {audio.shape}")
    if audio.dtype == np.int16:
        return audio
    if audio.size and np.abs(audio).max() > 1:
        audio = audio / 32768.0
    return audio.astype(np.float32)


_CONV_DTYPES = {None: None, torch.bfloat16: torch.bfloat16,
                torch.int8: torch.int8, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def _conv_dtype(value) -> Optional[torch.dtype]:
    """``vocoder_conv_dtype`` -> None (float32), torch.bfloat16 or
    torch.int8."""
    try:
        return _CONV_DTYPES[value]
    except (KeyError, TypeError):
        raise ValueError("vocoder_conv_dtype must be None, torch.bfloat16, "
                         f"torch.int8, 'bfloat16' or 'int8', got {value!r}"
                         ) from None


def _check_lowering_switches(fused_vocoder, packed_vocoder,
                             kernel_pipeline) -> None:
    if not isinstance(fused_vocoder, bool):
        raise ValueError(f"fused_vocoder must be a bool, got {fused_vocoder!r}")
    if packed_vocoder is not None and not isinstance(packed_vocoder, bool):
        raise ValueError("packed_vocoder must be None or a bool, got "
                         f"{packed_vocoder!r}")
    if isinstance(kernel_pipeline, bool) or not isinstance(
            kernel_pipeline, int) or kernel_pipeline < 1:
        raise ValueError("vocoder_kernel_pipeline must be an int >= 1, got "
                         f"{kernel_pipeline!r}")


class FlowHighSR:
    def __init__(self, config: FlowHighConfig = FlowHighConfig(), params=None,
                 vocoder_params=None, *, cfm_method: Optional[str] = None,
                 sigma: Optional[float] = None,
                 ode_method: Optional[str] = None,
                 prior_semantics: str = "reference",
                 upsampling_method: str = "scipy", fuse_act_conv=True,
                 vocoder_conv_dtype=None, vocoder_storage_dtype=None,
                 fused_vocoder: bool = False,
                 packed_vocoder: Optional[bool] = None,
                 vocoder_kernel_pipeline: int = 1, device=None):
        """``params``/``vocoder_params``: the JAX package's param trees
        (nested dicts of arrays), carried across by ``compat.jax_params``;
        without them the networks keep their constructor init until
        ``init_params``. ``fuse_act_conv`` (True | False | "auto" |
        "pairs") chooses the vocoder's kernels (``models/bigvgan.py``).
        ``vocoder_conv_dtype`` (None | torch.bfloat16 | torch.int8 |
        "bfloat16" | "int8") is the dot precision of the vocoder's convs, as
        the JAX package's switch of the same name; every entry point below
        inherits it. ``vocoder_storage_dtype`` is not ported.
        ``fused_vocoder`` (a bool), ``packed_vocoder`` (None or a bool) and
        ``vocoder_kernel_pipeline`` (an int >= 1) are the JAX constructor's
        TPU lowering switches: accepted and validated so that its calls
        build the port's model, and otherwise ignored, since the card's
        kernels do not depend on them (``ValueError`` on another value).
        ``device=None`` means CUDA, and raises without it."""
        _check_lowering_switches(fused_vocoder, packed_vocoder,
                                 vocoder_kernel_pipeline)
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
        if vocoder_storage_dtype is not None:
            raise NotImplementedError(
                "vocoder_storage_dtype (bf16 feature maps through kernels A-E) "
                "is not ported (ROADMAP.md queue 1 item 15)")
        self.vocoder_conv_dtype = _conv_dtype(vocoder_conv_dtype)

        self.net = VectorFieldNet(config.model).eval()
        self.vocoder = BigVGAN(config.vocoder, fuse_act_conv,
                               self.vocoder_conv_dtype).eval()
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

    def set_cfm_method(self, cfm_method: str) -> None:
        if cfm_method not in CFMConfig.CFM_METHODS:
            raise ValueError(f"unknown cfm_method {cfm_method!r}")
        self.cfm_method = cfm_method

    def _default_stds(self):
        """(std_1, std_2) of the prior: the reference's executed behaviour,
        ``(1.0, sigma)`` for every method (see the JAX package's
        ``FlowHighSR._default_stds``)."""
        return 1.0, self.sigma

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # -- the clip pipeline ------------------------------------------------------

    def _prep_and_solve(self, audio: torch.Tensor, n_valid: torch.Tensor,
                        generator: torch.Generator, in_sr: int, target_sr: int,
                        time_steps: int):
        """Upsample + peak-norm + mel encode + cutoff + prior + ODE solve.
        ``audio`` [B, T_pad], ``n_valid`` [B] true sample counts (device).
        Returns (sampled mel [B, F, M], cond wav [B, T48], n_valid48 [B])."""
        hop = self.config.mel.hop_length
        cond = resample_poly(audio, target_sr, in_sr)  # [B, T48_pad]
        # exact floor(n * up / down) without overflow
        up, down = _rates(target_sr, in_sr)
        n_valid = n_valid.to(torch.int64)
        n_valid48 = (n_valid // down) * up + (n_valid % down) * up // down

        t48 = cond.shape[-1]
        valid = torch.arange(t48, device=cond.device)[None, :] \
            < n_valid48[:, None]
        cond = torch.where(valid, cond, torch.zeros((), device=cond.device))
        peak = torch.amax(torch.abs(cond), dim=-1, keepdim=True)
        cond = cond / torch.clamp(peak, min=1e-8)  # silence-safe

        cond_mel = mel_encode(cond, self.config.mel)     # [B, F, 256]
        n_frames = cond_mel.shape[1]
        frame_mask = (torch.arange(n_frames, device=cond.device)[None, :]
                      < (n_valid48[:, None] + hop - 1) // hop)
        cutoff = mel_cutoff_bins(cond_mel)

        # the vector field runs row by row: its matmuls at the height of one
        # clip sum in the same order whatever the batch, so a clip's output
        # does not depend on the clips batched with it (at full width
        # batching moved the 48 kHz output by up to 1.6e-4 on an H100;
        # chip_smoke.py's serving phase holds it to 1e-4)
        def ode_fn(t, x):
            return torch.cat([
                forward_with_cond_scale(self.net, x[i:i + 1], times=t,
                                        cond=cond_mel[i:i + 1], cond_scale=1.0,
                                        mask=frame_mask[i:i + 1])
                for i in range(x.shape[0])])

        std_1, std_2 = self._default_stds()
        y0 = sample_prior(generator, self.cfm_method, cond_mel, std_1, std_2,
                          cutoff)
        sampled = odeint_fixed(ode_fn, y0, time_steps, self.ode_method)
        return sampled, cond, n_valid48

    def _align_and_splice(self, hr: torch.Tensor, cond: torch.Tensor,
                          n_valid48: torch.Tensor) -> torch.Tensor:
        """Length-align the vocoded audio with the upsampled source, zero the
        padding of each row, and run the spectral low-band splice."""
        t_out = min(hr.shape[-1], cond.shape[-1])
        keep = torch.arange(t_out, device=hr.device)[None, :] \
            < n_valid48[:, None]
        hr = torch.where(keep, hr[..., :t_out], torch.zeros((), device=hr.device))
        return post_process(hr, cond[..., :t_out], t_out)

    def _generate_impl(self, audio: torch.Tensor, n_valid: torch.Tensor,
                       generator: torch.Generator, in_sr: int, target_sr: int,
                       time_steps: int):
        """[B, T_pad] float32 audio and [B] lengths on the device ->
        (out [B, T48], n_valid48 [B]) on the device, with no host sync."""
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
        audio = prepare_clip(audio)
        n = len(audio)
        padded = np.zeros(padded_length(n, sr, target_sampling_rate),
                          audio.dtype)
        padded[:n] = audio
        out, _ = self.dispatch_generate(padded[None], np.array([n]), sr,
                                        target_sampling_rate, timestep, seed)
        n48 = valid_samples_48k(n, sr, target_sampling_rate)
        return out[:, :n48].cpu().numpy()

    def dispatch_generate(self, batch, lens, sr: int,
                          target_sampling_rate: int = 48000,
                          timestep: int = 1, seed: int = 0,
                          generator: Optional[torch.Generator] = None,
                          wire: Optional[str] = None):
        """Run one pre-padded [B, T] batch (numpy or tensor; int16 rides the
        int16 input wire) with true lengths ``lens`` [B] and return the
        DEVICE tensors (out [B, T48], n_valid48 [B]) without waiting for
        the device: the work is queued on the current stream. ``generator``
        (on the model's device) overrides ``seed``. ``wire='int16'``
        converts the output to int16 on the device (``_wire_int16``); the
        caller divides by 32767 to recover float. Unlike the JAX package's
        version there is no third (adaptive-solver statistics) result: the
        adaptive solver is not ported."""
        if wire not in (None, "float32", "int16"):
            raise ValueError(f"wire must be None|'float32'|'int16', got {wire!r}")
        batch = torch.as_tensor(batch).to(self.device, non_blocking=True)
        lens = torch.as_tensor(lens).to(self.device, non_blocking=True)
        if batch.dtype == torch.int16:
            batch = batch.to(torch.float32) / 32768.0
        if generator is None:
            generator = self.generator(seed)
        with torch.inference_mode():
            out, n48 = self._generate_impl(batch, lens, generator, int(sr),
                                           int(target_sampling_rate),
                                           int(timestep))
            if wire == "int16":
                out = _wire_int16(out)
        return out, n48

    def generate_batch(self, audios: list, srs,
                       target_sampling_rate: int = 48000, timestep: int = 1,
                       seed: int = 0) -> list:
        """Batched serving: clips grouped by input rate, each group padded to
        a shared bucket and run as one batch whose prior draws from one
        generator seeded with ``seed``. A rate group whose clips are all
        int16 rides the int16 input wire; a mixed group is scaled to float32
        on the host (identical results)."""
        if isinstance(srs, int):
            srs = [srs] * len(audios)
        prepped = [prepare_clip(a) for a in audios]
        by_rate: dict = {}
        for i, r in enumerate(srs):
            by_rate.setdefault(int(r), []).append(i)
        outs: list = [None] * len(audios)
        for rate, idxs in by_rate.items():
            n_pad = padded_length(max(len(prepped[i]) for i in idxs), rate,
                                  target_sampling_rate)
            all_i16 = all(prepped[i].dtype == np.int16 for i in idxs)
            batch = np.zeros((len(idxs), n_pad),
                             np.int16 if all_i16 else np.float32)
            for row, i in enumerate(idxs):
                a = prepped[i]
                if not all_i16 and a.dtype == np.int16:
                    a = a.astype(np.float32) / 32768.0
                batch[row, :len(a)] = a
            lens = np.array([len(prepped[i]) for i in idxs])
            out, _ = self.dispatch_generate(batch, lens, rate,
                                            target_sampling_rate, timestep,
                                            seed)
            out = out.cpu().numpy()
            for row, i in enumerate(idxs):
                n48 = valid_samples_48k(len(prepped[i]), rate,
                                        target_sampling_rate)
                outs[i] = out[row:row + 1, :n48]
        return outs

    # -- long-form single-pass mode ---------------------------------------------

    def vocode_chunked(self, mel, chunk_frames: int = 1000,
                       overlap_frames: int = 32) -> torch.Tensor:
        """Chunked BigVGAN decode, equal to the whole one: [B, F, M] mel ->
        [B, F * hop] waveform, a tensor on the model's device.

        Every window holds ``chunk + 2 * overlap`` real mel frames (shifted
        inward at the clip's edges, never zero-padded), so each output
        sample sees the same frames as in the whole decode: BigVGAN is a
        pure conv stack whose receptive field is far inside 32 frames. Only
        the last window's transposed-conv tail is kept past its chunk, as
        the whole decode computes it. All windows are queued on the current
        stream; nothing is read back."""
        hop = self.config.mel.hop_length
        mel = torch.as_tensor(mel, device=self.device)
        f = mel.shape[1]
        f_prog = chunk_frames + 2 * overlap_frames
        with torch.inference_mode():
            if f <= f_prog:
                return self.vocoder(mel)
            parts = []
            for c0 in range(0, f, chunk_frames):
                c1 = min(c0 + chunk_frames, f)
                lo = max(0, min(c0 - overlap_frames, f - f_prog))
                out = self.vocoder(mel[:, lo:lo + f_prog])
                off = (c0 - lo) * hop
                n = out.shape[-1] - off if c1 == f else (c1 - c0) * hop
                parts.append(out[:, off:off + n])
            return torch.cat(parts, dim=1)

    def generate_longform(self, audio: np.ndarray, sr: int,
                          target_sampling_rate: int = 48000, timestep: int = 1,
                          seed: int = 0, vocoder_chunk_frames: int = 1000,
                          vocoder_overlap_frames: int = 32) -> np.ndarray:
        """Single-pass long-form inference: [T] or [1, T] waveform at ``sr``
        -> [1, T'] at 48 kHz. The vector field sees the whole clip at once
        (no seams from chunked flow matching); only the vocoder runs in
        windows (``vocode_chunked``, equal to the whole decode), and the
        spectral splice runs over the whole waveform.

        Build the model with ``ModelConfig(attn_flash=True)``: the attention
        then runs kernel F at O(N) memory, where the dense scores of a
        5-minute clip (30,000 frames) would take 57.6 GB. Input handling is
        the JAX package's for this mode: float or int16 samples are divided
        by 32768 when |max| > 1. The result is read back once."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio[0]
        audio = prepare_clip(audio.astype(np.float32))
        n = len(audio)
        padded = np.zeros(padded_length(n, sr, target_sampling_rate),
                          np.float32)
        padded[:n] = audio
        batch = torch.from_numpy(padded)[None].to(self.device)
        lens = torch.tensor([n], device=self.device)
        with torch.inference_mode():
            sampled, cond, n_valid48 = self._prep_and_solve(
                batch, lens, self.generator(seed), int(sr),
                int(target_sampling_rate), int(timestep))
            hr = self.vocode_chunked(sampled, vocoder_chunk_frames,
                                     vocoder_overlap_frames)
            out = self._align_and_splice(hr, cond, n_valid48)
        n48 = valid_samples_48k(n, sr, target_sampling_rate)
        return out[:, :n48].cpu().numpy()

    # -- checkpoint loading ------------------------------------------------------

    @classmethod
    def from_local(cls, ckpt_dir, device=None,
                   model_file: str = "FLowHigh_basic_400k.pt",
                   cfm_method: Optional[str] = None,
                   model_config: Optional[ModelConfig] = None,
                   **kwargs) -> "FlowHighSR":
        """Load the published PyTorch checkpoint layout from a directory:
        ``bigvgan_48khz_256band.json`` (the vocoder's config),
        ``bigvgan_48khz_256band.pt`` (``{'generator': state dict}``, weight
        norm folded here) and ``model_file`` (``{'model': state dict}`` with
        the ``flowhigh.`` prefix). ``model_config`` defaults to the published
        vector field (``ModelConfig()``); ``cfm_method`` to ``basic_cfm`` as
        in the JAX package. Other keyword arguments go to the constructor."""
        from .compat.torch_ckpt import load_flowhigh_checkpoint
        return load_flowhigh_checkpoint(cls, Path(ckpt_dir), model_file,
                                        cfm_method, model_config, device,
                                        **kwargs)

    @classmethod
    def from_pretrained(cls, device=None, **kwargs) -> "FlowHighSR":
        """Fetch the published checkpoint (``ResembleAI/FlowHigh`` on the
        Hugging Face hub: both configs and both weight files) with
        ``huggingface_hub`` and hand its directory to ``from_local``. Needs
        network access; without ``huggingface_hub`` it raises and names
        ``from_local``."""
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as e:
            raise RuntimeError(
                "huggingface_hub is unavailable; download the checkpoint files "
                "manually and use FlowHighSR.from_local(ckpt_dir)") from e
        local = None
        for fpath in ("FLowHigh_basic_400k.json", "bigvgan_48khz_256band.json",
                      "FLowHigh_basic_400k.pt", "bigvgan_48khz_256band.pt"):
            local = hf_hub_download(repo_id="ResembleAI/FlowHigh",
                                    filename=fpath)
        return cls.from_local(Path(local).parent, device=device, **kwargs)
