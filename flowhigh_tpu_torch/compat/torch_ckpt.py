"""The published PyTorch checkpoints -> this package's modules, with no
second mapping: the port's modules keep the reference's state-dict names.
Counterpart of ``flowhigh_tpu/compat/torch_ckpt.py:load_flowhigh_checkpoint``
(which maps the same files into JAX param trees).

Checkpoint schemas (the reference's):

- model package ``{'model': state_dict, ...}`` whose keys carry the
  ``flowhigh.`` prefix (and ``module.`` when saved from DDP), with the frozen
  vocoder embedded under ``flowhigh.audio_enc_dec.vocoder.`` (ignored here:
  the standalone vocoder file is the one loaded);
- vocoder package ``{'generator': state_dict}`` with weight norm as
  ``weight_g`` / ``weight_v`` pairs, folded by ``fold_state_dict``.

Files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only, never pickled code.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from ..config import FlowHighConfig, ModelConfig, VocoderConfig
from ..models.bigvgan import kaiser_sinc_filter1d
from .jax_params import fold_state_dict

VOCODER_CONFIG = "bigvgan_48khz_256band.json"
VOCODER_FILE = "bigvgan_48khz_256band.pt"


def vocoder_config_from_json(path) -> VocoderConfig:
    """The reference vocoder config JSON -> ``VocoderConfig``."""
    with open(path) as f:
        h = json.load(f)
    return VocoderConfig(
        num_mels=h["num_mels"],
        upsample_initial_channel=h["upsample_initial_channel"],
        upsample_rates=tuple(h["upsample_rates"]),
        upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        resblock=str(h["resblock"]),
        resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d)
                                      for d in h["resblock_dilation_sizes"]),
        activation=h.get("activation", "snakebeta"),
        snake_logscale=bool(h.get("snake_logscale", True)),
    )


def vocoder_state_from_reference(sd: dict, expected: dict) -> dict:
    """Reference generator state dict (weight-normed or folded) -> the
    port's ``BigVGAN`` state dict. The port's modules carry the reference's
    names for both resblock types (``resblocks.{n}.convs{1,2}.{j}`` and
    ``activations.{m}`` for "1", ``resblocks.{n}.convs.{j}`` and
    ``activations.{j}`` for "2"), so the keys map one to one. ``expected`` is the target module's own
    state dict: alias-free filter buffers missing from the file are rebuilt
    (they are fixed Kaiser-sinc taps), anything else missing raises."""
    out = fold_state_dict(sd)
    filt = torch.from_numpy(kaiser_sinc_filter1d(0.25, 0.3, 12).reshape(1, 1, 12))
    for key in expected:
        if key not in out and key.endswith(("upsample.filter",
                                            "downsample.filter")):
            out[key] = filt.clone()
    return _select(out, expected, "vocoder")


def vector_field_state_from_reference(sd: dict, expected: dict) -> dict:
    """Reference ``FLowHigh`` state dict (``flowhigh.`` / ``module.``
    prefixes optional) -> the port's ``VectorFieldNet`` state dict: either
    backbone, register tokens and skip combiners included (the port's
    modules carry the reference's names)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if any(".1.to_qkva" in k or "gate_loop" in k for k in sd):
        raise NotImplementedError(
            "checkpoint contains GateLoop layers (layers.N.1.*): the "
            "reference's GateLoop weights come from the external "
            "gateloop_transformer package and have no layout to map onto "
            "this package's GateLoop (the JAX package refuses them too)")
    out = {k.removeprefix("flowhigh."): v for k, v in sd.items()
           if not k.startswith("flowhigh.audio_enc_dec.")}
    return _select(out, expected, "vector field")


def _select(sd: dict, expected: dict, what: str) -> dict:
    missing = sorted(k for k in expected if k not in sd)
    if missing:
        raise KeyError(f"{what} checkpoint lacks {len(missing)} tensors, "
                       f"e.g. {missing[:3]}")
    bad = [k for k in expected if tuple(sd[k].shape) != tuple(expected[k].shape)]
    if bad:
        raise ValueError(f"{what} checkpoint shapes differ from the config "
                         f"at {bad[:3]}")
    return {k: torch.as_tensor(sd[k]).to(torch.float32) for k in expected}


def load_flowhigh_checkpoint(cls, ckpt_dir: Path, model_file: str,
                             cfm_method: Optional[str] = None,
                             model_config: Optional[ModelConfig] = None,
                             device=None, **kwargs):
    """Directory layout of the published checkpoints -> ``cls`` (a
    ``FlowHighSR``) on ``device``."""
    ckpt_dir = Path(ckpt_dir)
    config = FlowHighConfig().replace(
        vocoder=vocoder_config_from_json(ckpt_dir / VOCODER_CONFIG),
        model=model_config or ModelConfig())
    sr = cls(config, cfm_method=cfm_method or "basic_cfm", device=device,
             **kwargs)
    voc_pkg = torch.load(ckpt_dir / VOCODER_FILE, map_location="cpu",
                         weights_only=True)
    sr.vocoder.load_state_dict(vocoder_state_from_reference(
        voc_pkg["generator"], sr.vocoder.state_dict()))
    pkg = torch.load(ckpt_dir / model_file, map_location="cpu",
                     weights_only=True)
    sr.net.load_state_dict(vector_field_state_from_reference(
        pkg["model"], sr.net.state_dict()))
    return sr
