"""The reference's mid-level API, ``FLowHigh`` and
``ConditionalFlowMatcherWrapper`` — counterpart of
``flowhigh_tpu/cfm_wrapper.py``, so that code written against the
reference's constructor keywords and wrapper methods runs on the port.

``FLowHigh`` bundles a ``VectorFieldNet`` (on CUDA unless ``device="cpu"``)
with its config and an optional ``MelVoco`` codec; the wrapper exposes
``sample``, ``forward`` (the training loss) and ``load``. Noise: JAX's
draws cannot be made in torch, so ``sample`` takes a caller's ``eps`` and
``forward`` a caller's ``cfm.TrainingDraws`` (or a ``torch.Generator``)
where the JAX wrapper takes ``rng``.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from .cfm import CFM_METHODS, TrainingDraws, cfm_training_loss
from .compat.jax_params import seeded_init_, vector_field_state_from_jax
from .compat.torch_ckpt import (vector_field_state_from_reference,
                                vocoder_config_from_json,
                                vocoder_state_from_reference)
from .config import ModelConfig
from .dsp import resample_poly
from .models import BigVGAN, MelVoco, VectorFieldNet
from .models.melvoco import encode
from .sr import _is_probably_audio, sample_mel, solve_ode
from .utils import resolve_device


class FLowHigh:
    """The reference constructor's keywords (``flow.py:55-75``) -> a
    ``ModelConfig`` and its ``VectorFieldNet``. ``params``: the JAX
    package's param tree, carried across by ``compat.jax_params``; else the
    module's init until ``init_params``. Keywords that the published
    configs never set and the JAX package does not carry raise
    ``NotImplementedError``, as there."""

    def __init__(
        self,
        *,
        audio_enc_dec: Optional[MelVoco] = None,
        dim_in: Optional[int] = None,
        dim_cond_emb: int = 0,
        dim: int = 1024,
        depth: int = 24,
        dim_head: int = 64,
        heads: int = 16,
        ff_mult: int = 4,
        ff_dropout: float = 0.0,
        time_hidden_dim: Optional[int] = None,
        conv_pos_embed_kernel_size: int = 31,
        conv_pos_embed_groups: Optional[int] = None,
        attn_dropout: float = 0.0,
        attn_flash: bool = False,
        attn_qk_norm: bool = True,
        use_gateloop_layers: bool = False,
        architecture: str = "transformer",
        num_register_tokens: int = 0,
        use_unet_skip_connection: bool = False,
        skip_connect_scale: Optional[float] = None,
        params=None,
        device=None,
    ):
        if dim_cond_emb != 0:
            raise NotImplementedError(
                "dim_cond_emb != 0 is accepted by the reference constructor "
                "but never fed by any reference code path; unsupported here")
        if time_hidden_dim is not None and time_hidden_dim != dim:
            raise NotImplementedError(
                "time_hidden_dim defaults to dim (flow.py:81-84); other "
                "values are not supported")
        if conv_pos_embed_groups is not None and conv_pos_embed_groups != dim:
            raise NotImplementedError(
                "conv_pos_embed_groups defaults to dim (depthwise); other "
                "values are not supported")
        self.audio_enc_dec = audio_enc_dec
        self.config = ModelConfig(
            architecture=architecture,
            dim_in=dim_in if dim_in is not None else dim,
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            ff_mult=ff_mult,
            conv_pos_embed_kernel_size=conv_pos_embed_kernel_size,
            attn_qk_norm=attn_qk_norm, attn_flash=attn_flash,
            ff_dropout=ff_dropout, attn_dropout=attn_dropout,
            num_register_tokens=num_register_tokens,
            use_unet_skip_connection=use_unet_skip_connection,
            skip_connect_scale=skip_connect_scale,
            use_gateloop_layers=use_gateloop_layers)
        self.device = resolve_device(device)
        self.net = VectorFieldNet(self.config).eval()
        if params is not None:
            self.net.load_state_dict(
                vector_field_state_from_jax(params, self.config))
        self.net.to(self.device)

    def init_params(self, seed: int = 0) -> None:
        """Seeded init (``compat.jax_params.seeded_init_``)."""
        seeded_init_(self.net, seed)

    @torch.inference_mode()
    def __call__(self, x, *, times, cond, cond_drop_mask=None, mask=None):
        return self.net(x, times=times, cond=cond,
                        cond_drop_mask=cond_drop_mask, mask=mask)


class ConditionalFlowMatcherWrapper:
    """The reference wrapper (``cfm_superresolution.py:94-527``) over a
    ``FLowHigh``. ``use_torchode=True`` selects the adaptive solver with
    the tsit5 tableau (the reference's torchode path), else
    ``torchdiffeq_ode_method`` ("euler" | "midpoint") on the fixed grid;
    ``ode_tableau`` names the adaptive tableau ("dopri5" by default).
    ``torchode_method_klass`` is accepted and unused, as in the JAX
    package; ``cond_drop_prob`` is the training loss's."""

    def __init__(
        self,
        flowhigh: FLowHigh,
        sigma: float = 0.0,
        ode_atol: float = 1e-5,
        ode_rtol: float = 1e-5,
        use_torchode: bool = False,
        cfm_method: str = "basic_cfm",
        torchdiffeq_ode_method: str = "midpoint",
        torchode_method_klass=None,
        cond_drop_prob: float = 0.0,
        ode_tableau: Optional[str] = None,
    ):
        del torchode_method_klass
        self.flowhigh = flowhigh
        self.sigma = sigma
        self.cfm_method = cfm_method
        self.ode_method = torchdiffeq_ode_method
        self.cond_drop_prob = cond_drop_prob
        self.use_adaptive = use_torchode
        self.ode_atol, self.ode_rtol = ode_atol, ode_rtol
        self.ode_tableau = ode_tableau or ("tsit5" if use_torchode
                                           else "dopri5")

    def _solve(self, ode_fn, y0: torch.Tensor, time_steps: int):
        method = "adaptive" if self.use_adaptive else self.ode_method
        return solve_ode(ode_fn, y0, time_steps, method, self.ode_atol,
                         self.ode_rtol, self.ode_tableau)

    def sample(self, *, cond=None, cond_mask=None, time_steps: int = 4,
               cond_scale: float = 1.0, decode_to_audio: bool = True,
               std_1: Optional[float] = None, std_2: Optional[float] = None,
               mel_pp: bool = False, cfm_method: Optional[str] = None,
               generator: Optional[torch.Generator] = None, eps=None):
        """``cond``: audio [B, T] or [B, 1, T] (mel-encoded by
        ``audio_enc_dec``) or a log-mel [B, T, M]; ``cond_mask`` [B, T]
        bool marks the valid frames. The stds and ``cfm_method`` follow the
        reference (``sr.sample_mel``). ``eps`` [B, T, M] is the prior's
        standard normal draw; without it ``generator`` (on the net's
        device) draws it, seeded 0 when None. Returns the waveform through
        ``audio_enc_dec.decode`` with ``decode_to_audio`` and a codec, else
        the mel, on the net's device."""
        fh = self.flowhigh
        enc = fh.audio_enc_dec
        cond = torch.as_tensor(cond, dtype=torch.float32, device=fh.device)
        if enc is None and _is_probably_audio(cond):
            raise ValueError("audio_enc_dec must be set to sample from audio")
        if generator is None:
            generator = torch.Generator(device=fh.device).manual_seed(0)
        sampled = sample_mel(
            fh.net, cond, device=fh.device,
            mel_cfg=None if enc is None else enc.mel_cfg,
            model_method=self.cfm_method, sigma=self.sigma, solve=self._solve,
            time_steps=time_steps, cond_scale=cond_scale, std_1=std_1,
            std_2=std_2, mel_pp=mel_pp, cfm_method=cfm_method,
            generator=generator, mask=cond_mask, eps=eps)
        if not decode_to_audio or enc is None:
            return sampled
        return enc.decode(sampled)

    def forward(self, x1, *, cond=None, cond_lengths=None, mask=None,
                cond_mask=None, input_sampling_rate=None,
                cond_freq_masking: bool = False, random_sr=None,
                weighted_loss: bool = False, cfm_method: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[TrainingDraws] = None) -> torch.Tensor:
        """The training loss (``cfm.cfm_training_loss``, the net in train
        mode) of targets ``x1`` against conditions ``cond``: each audio
        ([B, T] or [B, 1, T], resampled from ``input_sampling_rate`` to the
        codec's rate and mel-encoded, no gradient) or a log-mel [B, T, M].
        Mels of unequal length are padded at the end (with the JAX
        wrapper's warning: the reference pads at the front) and
        ``cond_lengths`` (frames, clipped to [1, T]; default all) marks
        the valid ones; crops of 2 s at the codec's rate. ``mask`` and
        ``cond_mask`` are accepted and ignored, and ``random_sr`` unused,
        as in the JAX wrapper. ``draws``: the loss's random numbers; else
        ``generator`` (seeded 0 on the net's device when None) draws them
        and the dropout masks. Needs ``audio_enc_dec`` for its mel
        config."""
        del mask, cond_mask, random_sr
        if cfm_method not in CFM_METHODS:
            cfm_method = self.cfm_method
        fh = self.flowhigh
        if fh.audio_enc_dec is None:
            raise ValueError("audio_enc_dec must be set")
        mel_cfg = fh.audio_enc_dec.mel_cfg
        x1, cond = (torch.as_tensor(a, dtype=torch.float32, device=fh.device)
                    for a in (x1, cond))
        codec_sr = mel_cfg.sampling_rate
        in_sr = int(input_sampling_rate or codec_sr)
        with torch.no_grad():
            x1, cond = (encode(resample_poly(a.reshape(a.shape[0], -1),
                                             codec_sr, in_sr), mel_cfg)
                        if _is_probably_audio(a) else a for a in (x1, cond))
        t = max(x1.shape[1], cond.shape[1])
        if x1.shape[1] != cond.shape[1]:
            warnings.warn(
                f"x1/cond mel lengths differ ({x1.shape[1]} vs "
                f"{cond.shape[1]}): end-padding to {t} (the reference would "
                "front-pad; its mask stays start-anchored)", stacklevel=2)
        x1, cond = (F.pad(a, (0, 0, 0, t - a.shape[1])) for a in (x1, cond))
        if cond_lengths is None:
            mel_lengths = torch.full((x1.shape[0],), t, device=fh.device)
        else:
            mel_lengths = torch.clamp(torch.as_tensor(
                cond_lengths, device=fh.device).to(torch.int64), 1, t)
        if generator is None and draws is None:
            generator = torch.Generator(device=fh.device).manual_seed(0)
        return cfm_training_loss(
            fh.net, x1, cond, mel_lengths, method=cfm_method,
            sigma=self.sigma,
            out_size=2 * mel_cfg.sampling_rate // mel_cfg.hop_length,
            cond_drop_prob=self.cond_drop_prob, weighted=weighted_loss,
            cond_freq_masking=cond_freq_masking, train=True, draws=draws,
            generator=generator)

    __call__ = forward

    def load(self, path, strict: bool = True):
        """Load a reference-layout checkpoint package (``{'model': state
        dict}``, ``flowhigh.`` prefixes) into the net and return it.
        ``strict`` is accepted and unused, as in the JAX package: a missing
        or misshapen tensor raises either way."""
        del strict
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(path)
        pkg = torch.load(path, map_location="cpu", weights_only=True)
        net = self.flowhigh.net
        net.load_state_dict(vector_field_state_from_reference(
            pkg["model"], net.state_dict()))
        return pkg


def init_bigvgan(vocoder_config, vocoder_path, vocoder_freeze: bool = True,
                 device=None):
    """The BigVGAN generator from its JSON config and reference checkpoint
    (``{'generator': state dict}`` or the state dict, weight norm folded):
    (``VocoderConfig``, ``BigVGAN`` in eval mode on ``device``, its
    parameters frozen with ``vocoder_freeze``). ``device``: the card unless
    ``"cpu"`` is asked for (``utils.resolve_device``)."""
    device = resolve_device(device)
    cfg = vocoder_config_from_json(vocoder_config)
    voc = BigVGAN(cfg).eval()
    pkg = torch.load(vocoder_path, map_location="cpu", weights_only=True)
    voc.load_state_dict(vocoder_state_from_reference(
        pkg.get("generator", pkg), voc.state_dict()))
    voc.requires_grad_(not vocoder_freeze)
    return cfg, voc.to(device)
