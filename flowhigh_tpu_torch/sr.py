"""FlowHighSR — any-rate -> 48 kHz super-resolution, counterpart of the
``generate`` / ``generate_batch`` / ``dispatch_generate`` /
``generate_longform`` / ``vocode_chunked`` / ``sample`` / ``from_local`` /
``from_pretrained`` surface of ``flowhigh_tpu/sr.py``.

One clip runs: polyphase upsample, masked peak-norm, mel encode, cutoff
search, prior, ODE solve of the vector field (fixed grid, or adaptive with
``ode_method="adaptive"`` / ``use_torchode=True``), BigVGAN vocode (the
port's CUDA kernels on the card), spectral low-band splice. Audio is
bucketed to 1 s multiples at 48 kHz as in the JAX package, so both see the
same padded shapes; the result is sliced back to the true length.

On the fixed grid ``_generate_impl`` reads nothing back from the device:
the true lengths go in as a tensor, the output length is computed on the
host from the same integers (``valid_samples_48k``), so a caller can keep
several clips in flight (``serving.ServingPipeline``). The adaptive solver
reads its loop condition back once per loop (``cfm.odeint_adaptive``).
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .cfm import (TABLEAUS, mel_cutoff_bins, mel_replace, odeint_adaptive,
                  odeint_fixed, sample_prior)
from .compat.jax_params import (seeded_init_, vector_field_state_from_jax,
                                vocoder_state_from_jax)
from .config import CFMConfig, FlowHighConfig, ModelConfig
from .dsp import resample_poly
from .models import BigVGAN, VectorFieldNet, forward_with_cond_scale, mel_encode
from .ops.quant import (check_lowering_switches, resolve_conv_dtype,
                        resolve_storage_dtype)
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


def _warn_if_unconverged(stats) -> None:
    """Warn when an adaptive solve left items short of t = 1 (they hit
    ``max_steps``): the last accepted state is returned for them. Reads
    ``stats`` back; ``None`` (the fixed grid) reads nothing."""
    if stats is None:
        return
    conv = stats.converged.cpu().numpy()
    if not conv.all():
        bad = np.where(~conv)[0].tolist()
        warnings.warn(
            f"adaptive ODE solver hit max_steps before reaching t=1 for "
            f"batch item(s) {bad}; returning the last accepted state. "
            f"Loosen atol/rtol or raise max_steps.", RuntimeWarning,
            stacklevel=3)


def _is_probably_audio(x: torch.Tensor) -> bool:
    """[B, T] or [B, 1, T] is audio, [B, T, M] a mel (the reference's
    rule)."""
    return x.ndim == 2 or (x.ndim == 3 and x.shape[1] == 1)


def row_field(net, cond_mel: torch.Tensor, mask: Optional[torch.Tensor],
              cond_scale: float = 1.0):
    """The ODE's right-hand side f(t, x) of the vector field ``net``, t []
    or [B]. The field runs row by row: its matmuls at the height of one
    clip sum in the same order whatever the batch, so a clip's output does
    not depend on the clips batched with it (at full width batching moved
    the 48 kHz output by up to 1.6e-4 on an H100; chip_smoke.py's serving
    phase holds it to 1e-4). Each row gets its own time when the adaptive
    solver passes one per item."""
    def ode_fn(t, x):
        return torch.cat([
            forward_with_cond_scale(
                net, x[i:i + 1], times=t[i:i + 1] if t.ndim else t,
                cond=cond_mel[i:i + 1], cond_scale=cond_scale,
                mask=None if mask is None else mask[i:i + 1])
            for i in range(x.shape[0])])
    return ode_fn


def solve_ode(ode_fn, y0: torch.Tensor, time_steps: int, method: str,
              atol: float, rtol: float, tableau: str):
    """(sampled, stats): ``method`` "euler" | "midpoint" on the fixed grid of
    ``time_steps`` steps (stats None), or "adaptive" (``odeint_adaptive``
    with ``tableau`` at ``atol``/``rtol``; its ``AdaptiveStats``)."""
    if method == "adaptive":
        return odeint_adaptive(ode_fn, y0, atol, rtol, return_stats=True,
                               tableau=tableau)
    return odeint_fixed(ode_fn, y0, time_steps, method), None


@torch.inference_mode()
def sample_mel(net, cond, *, device, mel_cfg, model_method: str,
               sigma: float, solve, time_steps: int = 4,
               cond_scale: float = 1.0, std_1: Optional[float] = None,
               std_2: Optional[float] = None, mel_pp: bool = False,
               cfm_method: Optional[str] = None,
               generator: Optional[torch.Generator] = None, mask=None,
               eps=None) -> torch.Tensor:
    """The sampling of ``FlowHighSR.sample`` and of
    ``cfm_wrapper.ConditionalFlowMatcherWrapper.sample``: ``cond`` (audio,
    mel-encoded with ``mel_cfg``, or a log-mel) -> the solved mel
    [B, T, M] on ``device``. ``cfm_method`` outside the known four falls
    back to ``model_method``; for any method but basic_cfm, unless both
    stds are given, both are (1, ``sigma``). ``solve(ode_fn, y0,
    time_steps)`` returns (sampled, stats)."""
    if cfm_method not in CFMConfig.CFM_METHODS:
        cfm_method = model_method
    if cfm_method != "basic_cfm" and (std_1 is None or std_2 is None):
        std_1, std_2 = 1.0, sigma
    if std_1 is None:
        std_1, std_2 = 1.0, 0.0  # unused by basic_cfm
    cond = torch.as_tensor(cond, dtype=torch.float32, device=device)
    if _is_probably_audio(cond):
        cond = mel_encode(cond.reshape(cond.shape[0], -1), mel_cfg)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    cutoff = mel_cutoff_bins(cond)
    y0 = sample_prior(generator, cfm_method, cond, float(std_1),
                      float(std_2), cutoff, eps)
    sampled, stats = solve(row_field(net, cond, mask, float(cond_scale)), y0,
                           int(time_steps))
    if mel_pp:
        sampled = mel_replace(sampled, cond, cutoff)
    _warn_if_unconverged(stats)
    return sampled


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


class FlowHighSR:
    def __init__(self, config: FlowHighConfig = FlowHighConfig(), params=None,
                 vocoder_params=None, *, cfm_method: Optional[str] = None,
                 sigma: Optional[float] = None,
                 ode_method: Optional[str] = None,
                 cond_drop_prob: float = 0.0,
                 prior_semantics: str = "reference",
                 upsampling_method: str = "scipy", fuse_act_conv=True,
                 vocoder_conv_dtype=None, vocoder_storage_dtype=None,
                 fused_vocoder: bool = False,
                 packed_vocoder: Optional[bool] = None,
                 vocoder_kernel_pipeline: int = 1,
                 use_torchode: bool = False, ode_atol: float = 1e-5,
                 ode_rtol: float = 1e-5, ode_tableau: Optional[str] = None,
                 device=None):
        """``params``/``vocoder_params``: the JAX package's param trees
        (nested dicts of arrays), carried across by ``compat.jax_params``;
        without them the networks keep their constructor init until
        ``init_params``. ``ode_method``: "euler" | "midpoint" (fixed grid)
        | "adaptive" (``cfm.odeint_adaptive`` at ``ode_atol``/``ode_rtol``
        with ``ode_tableau``, "dopri5" by default); ``use_torchode=True``
        (the reference's flag) means "adaptive" with "tsit5", the tableau
        torchode instantiates. ``cond_drop_prob`` is kept for training and
        has no effect on inference. ``prior_semantics``: "reference" (the
        reference's executed prior) | "paper" (see ``_default_stds``).
        ``upsampling_method``: "scipy" (``resample_poly``'s scipy design) |
        "librosa" (its soxr_hq design). ``fuse_act_conv`` (True | False | "auto" |
        "pairs") chooses the vocoder's kernels (``models/bigvgan.py``).
        ``vocoder_conv_dtype`` (None | torch.bfloat16 | torch.int8 |
        "bfloat16" | "int8") is the dot precision of the vocoder's convs, as
        the JAX package's switch of the same name; every entry point below
        inherits it. ``vocoder_storage_dtype`` (None | torch.float32 |
        torch.bfloat16, or their names: the JAX package's ``jnp.bfloat16``)
        is the dtype of the vocoder's feature maps in device memory, the JAX
        package's switch of the same name (``models/bigvgan.py``); the
        attribute holds None (float32) or torch.bfloat16.
        ``fused_vocoder`` (a bool), ``packed_vocoder`` (None or a bool) and
        ``vocoder_kernel_pipeline`` (an int >= 1) are the JAX constructor's
        TPU lowering switches: accepted and validated so that its calls
        build the port's model, and otherwise ignored, since the card's
        kernels do not depend on them (``ValueError`` on another value).
        ``device=None`` means CUDA, and raises without it."""
        check_lowering_switches(fused_vocoder, packed_vocoder,
                                vocoder_kernel_pipeline)
        self.config = config
        self.device = resolve_device(device)
        self.cfm_method = cfm_method or config.cfm.cfm_method
        if self.cfm_method not in CFMConfig.CFM_METHODS:
            raise ValueError(f"unknown cfm_method {self.cfm_method!r}")
        self.sigma = config.cfm.sigma if sigma is None else sigma
        self.ode_method = ode_method or config.cfm.ode_method
        if use_torchode:  # the reference's flag: the adaptive solver
            self.ode_method = "adaptive"
        if self.ode_method not in ("euler", "midpoint", "adaptive"):
            raise ValueError(f"unknown ode_method {self.ode_method!r}")
        self.ode_atol, self.ode_rtol = ode_atol, ode_rtol
        self.ode_tableau = ode_tableau or ("tsit5" if use_torchode
                                           else "dopri5")
        if self.ode_tableau not in TABLEAUS:
            raise ValueError(f"unknown tableau {self.ode_tableau!r} "
                             f"(options: {sorted(TABLEAUS)})")
        self.cond_drop_prob = cond_drop_prob
        if upsampling_method not in ("scipy", "librosa"):
            raise ValueError(f"upsampling_method must be 'scipy' or 'librosa', "
                             f"got {upsampling_method!r}")
        self.upsampling_method = upsampling_method
        if prior_semantics not in ("reference", "paper"):
            raise ValueError(f"prior_semantics must be 'reference' or 'paper', "
                             f"got {prior_semantics!r}")
        self.prior_semantics = prior_semantics
        self.vocoder_conv_dtype = resolve_conv_dtype(vocoder_conv_dtype)
        self.vocoder_storage_dtype = resolve_storage_dtype(
            vocoder_storage_dtype)

        self.net = VectorFieldNet(config.model).eval()
        self.vocoder = BigVGAN(config.vocoder, fuse_act_conv,
                               self.vocoder_conv_dtype,
                               self.vocoder_storage_dtype).eval()
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
        """(std_1, std_2) of the prior that ``generate`` uses. "reference":
        the reference's executed behaviour, ``(1.0, sigma)`` for every
        method (its ``sample()`` overwrites the ``std_2 = 1`` its
        ``generate()`` passes). "paper": the intended ``std_2 = 1`` for
        independent_cfm_adaptive (prior N(cond, 1)), ``sigma`` for the
        others. As the JAX package's ``FlowHighSR._default_stds``."""
        if self.prior_semantics == "reference":
            return 1.0, self.sigma
        std_2 = (1.0 if self.cfm_method == "independent_cfm_adaptive"
                 else self.sigma)
        return 1.0, std_2

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # -- the clip pipeline ------------------------------------------------------

    def _solve(self, ode_fn, y0: torch.Tensor, time_steps: int):
        """(sampled, stats) by the model's ``ode_method``: the adaptive
        solver's ``AdaptiveStats``, or None on the fixed grid."""
        return solve_ode(ode_fn, y0, time_steps, self.ode_method,
                         self.ode_atol, self.ode_rtol, self.ode_tableau)

    def _prep_and_solve(self, audio: torch.Tensor, n_valid: torch.Tensor,
                        generator: torch.Generator, in_sr: int, target_sr: int,
                        time_steps: int):
        """Upsample + peak-norm + mel encode + cutoff + prior + ODE solve.
        ``audio`` [B, T_pad], ``n_valid`` [B] true sample counts (device).
        Returns (sampled mel [B, F, M], cond wav [B, T48], n_valid48 [B],
        stats: ``AdaptiveStats`` or None on the fixed grid)."""
        hop = self.config.mel.hop_length
        design = "soxr_hq" if self.upsampling_method == "librosa" else "scipy"
        cond = resample_poly(audio, target_sr, in_sr, design)  # [B, T48_pad]
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

        std_1, std_2 = self._default_stds()
        y0 = sample_prior(generator, self.cfm_method, cond_mel, std_1, std_2,
                          cutoff)
        sampled, stats = self._solve(row_field(self.net, cond_mel, frame_mask),
                                     y0, time_steps)
        return sampled, cond, n_valid48, stats

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
        (out [B, T48], n_valid48 [B], stats) on the device; ``stats`` is the
        adaptive solver's ``AdaptiveStats``, None on the fixed grid, which
        runs with no host sync."""
        sampled, cond, n_valid48, stats = self._prep_and_solve(
            audio, n_valid, generator, in_sr, target_sr, time_steps)
        hr = self.vocoder(sampled)                     # [B, F * hop]
        return self._align_and_splice(hr, cond, n_valid48), n_valid48, stats

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
        out, _, stats = self.dispatch_generate(
            padded[None], np.array([n]), sr, target_sampling_rate, timestep,
            seed)
        _warn_if_unconverged(stats)
        n48 = valid_samples_48k(n, sr, target_sampling_rate)
        return out[:, :n48].cpu().numpy()

    def dispatch_generate(self, batch, lens, sr: int,
                          target_sampling_rate: int = 48000,
                          timestep: int = 1, seed: int = 0,
                          generator: Optional[torch.Generator] = None,
                          wire: Optional[str] = None):
        """Run one pre-padded [B, T] batch (numpy or tensor; int16 rides the
        int16 input wire) with true lengths ``lens`` [B] and return the
        DEVICE tensors (out [B, T48], n_valid48 [B], stats), as the JAX
        package does. On the fixed grid ``stats`` is None and nothing waits
        for the device: the work is queued on the current stream. Under
        ``ode_method="adaptive"`` ``stats`` is the solver's
        ``AdaptiveStats`` (device tensors), and the call waits on the
        device once per solver loop (``cfm.odeint_adaptive``); pass it to
        ``_warn_if_unconverged`` once the result is fetched. ``generator``
        (on the model's device) overrides ``seed``. ``wire='int16'``
        converts the output to int16 on the device (``_wire_int16``); the
        caller divides by 32767 to recover float."""
        if wire not in (None, "float32", "int16"):
            raise ValueError(f"wire must be None|'float32'|'int16', got {wire!r}")
        batch = torch.as_tensor(batch).to(self.device, non_blocking=True)
        lens = torch.as_tensor(lens).to(self.device, non_blocking=True)
        if batch.dtype == torch.int16:
            batch = batch.to(torch.float32) / 32768.0
        if generator is None:
            generator = self.generator(seed)
        with torch.inference_mode():
            out, n48, stats = self._generate_impl(
                batch, lens, generator, int(sr), int(target_sampling_rate),
                int(timestep))
            if wire == "int16":
                out = _wire_int16(out)
        return out, n48, stats

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
            out, _, stats = self.dispatch_generate(
                batch, lens, rate, target_sampling_rate, timestep, seed)
            _warn_if_unconverged(stats)
            out = out.cpu().numpy()
            for row, i in enumerate(idxs):
                n48 = valid_samples_48k(len(prepped[i]), rate,
                                        target_sampling_rate)
                outs[i] = out[row:row + 1, :n48]
        return outs

    # -- sampling --------------------------------------------------------------

    @torch.inference_mode()
    def sample(self, *, cond, time_steps: int = 4, cond_scale: float = 1.0,
               decode_to_audio: bool = True, std_1: Optional[float] = None,
               std_2: Optional[float] = None, mel_pp: bool = False,
               cfm_method: Optional[str] = None,
               generator: Optional[torch.Generator] = None, mask=None,
               eps=None) -> torch.Tensor:
        """ODE sampling from a condition, the JAX package's
        ``FlowHighSR.sample`` (the reference's ``sample``).

        ``cond``: audio [B, T] or [B, 1, T] (mel-encoded first, with no
        peak-norm) or a log-mel [B, T, M]. ``cond_scale`` != 1 mixes the
        conditional and null branches (classifier-free guidance). The stds
        follow the reference: for any method but basic_cfm, unless both are
        given, both are overwritten with (1, sigma). ``mel_pp`` keeps the
        condition's bins below its cutoff. ``cfm_method`` outside the known
        four falls back to the model's. ``generator`` (on the model's
        device) draws the prior, seeded 0 when None; ``eps`` [B, T, M]
        replaces that draw (``cfm.sample_prior``). ``mask`` [B, T] bool
        marks the valid frames. The solver is the model's ``ode_method``
        (``time_steps`` steps on the fixed grid). Returns a tensor on the
        model's device: the waveform [B, T * hop] through ``self.vocoder``
        (the port's kernels on the card) with ``decode_to_audio``, else the
        mel [B, T, M]."""
        sampled = sample_mel(
            self.net, cond, device=self.device, mel_cfg=self.config.mel,
            model_method=self.cfm_method, sigma=self.sigma, solve=self._solve,
            time_steps=time_steps, cond_scale=cond_scale, std_1=std_1,
            std_2=std_2, mel_pp=mel_pp, cfm_method=cfm_method,
            generator=generator or self.generator(0), mask=mask, eps=eps)
        return self.vocoder(sampled) if decode_to_audio else sampled

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
            sampled, cond, n_valid48, stats = self._prep_and_solve(
                batch, lens, self.generator(seed), int(sr),
                int(target_sampling_rate), int(timestep))
            _warn_if_unconverged(stats)
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
