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

The vocoder trainer's ``g_<step>`` package goes the other way:
``vocoder_state_to_reference`` (counterpart of
``flowhigh_tpu/compat/torch_ckpt.py:vocoder_params_to_torch_state``).
The vector field trainer's export too: ``reference_param_order``,
``optim_state_to_reference`` and ``scheduler_state_to_reference`` write
the reference's ``{'model', 'optim', 'scheduler'}`` package, whose optimizer
state a ``torch.optim.Adam(flowhigh.parameters())`` built the reference's
way loads (counterparts of ``flowhigh_tpu/compat/torch_ckpt.py:424, 489,
537``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
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


def vocoder_state_to_reference(state_dict: dict, voc_cfg: VocoderConfig
                               ) -> dict:
    """A ``BigVGAN`` state dict (folded weights) -> the reference's
    weight-normed ``ckpt['generator']`` layout, as the JAX package exports
    its generator: each conv weight w re-emitted as ``weight_v = w``,
    ``weight_g = |w|`` over all but dim 0 (``fold_state_dict`` inverts it
    exactly), biases and snake parameters as they are, the alias-free
    filter buffers omitted (the reference's modules rebuild them). The norm
    is summed over the JAX kernel layout's transposed view, in the JAX
    export's order, so both packages write the same bits. The keys come
    from the state dict (the port's names are the reference's); it must
    hold ``voc_cfg``'s resblocks."""
    n_blocks = len(voc_cfg.upsample_rates) * len(voc_cfg.resblock_kernel_sizes)
    blocks = {int(k.split(".")[1]) for k in state_dict
              if k.startswith("resblocks.")}
    if blocks != set(range(n_blocks)):
        raise ValueError(f"vocoder state dict holds resblocks {sorted(blocks)}"
                         f", the config {n_blocks}")
    out: dict = {}
    for key, val in state_dict.items():
        if key.endswith(("upsample.filter", "downsample.filter")):
            continue
        val = val.detach().cpu().to(torch.float32)
        if not key.endswith(".weight"):
            out[key] = val.clone()
            continue
        base = key[: -len(".weight")]
        perm = tuple(reversed(range(val.ndim)))  # the JAX kernel's layout
        w = np.ascontiguousarray(val.numpy().transpose(perm)).transpose(perm)
        axes = tuple(range(1, w.ndim))
        out[base + ".weight_g"] = torch.from_numpy(
            np.sqrt(np.sum(w * w, axis=axes, keepdims=True)).astype(np.float32))
        out[base + ".weight_v"] = torch.from_numpy(w.copy())
    return out


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


# --- the trainer's export in the reference's layout ---------------------------------

def reference_param_order(model_cfg: ModelConfig) -> list:
    """Vector-field parameter names in the reference's ``named_parameters()``
    order, which is the positional index of a torch ``Adam(flowhigh
    .parameters())`` state dict. torch yields a module's direct parameters
    before its submodules', so ``null_cond`` (the net's one direct
    Parameter) comes first, a Transformer's ``register_tokens`` before its
    layers and a ConvNeXt block's ``gamma`` before its convs. The port's
    ``VectorFieldNet`` registers its parameters in this order."""
    order = [
        "null_cond",
        "sinu_pos_emb.0.weights", "sinu_pos_emb.1.weight", "sinu_pos_emb.1.bias",
        "to_embed.weight", "to_embed.bias",
        "conv_embed.dw_conv1d.0.weight", "conv_embed.dw_conv1d.0.bias",
    ]
    if model_cfg.architecture == "transformer":
        if model_cfg.num_register_tokens > 0:
            order += ["transformer.register_tokens"]
        for i in range(model_cfg.depth):
            L = f"transformer.layers.{i}."
            if model_cfg.use_unet_skip_connection and i >= model_cfg.depth // 2:
                order += [L + "0.weight", L + "0.bias"]
            order += [L + "2.to_gamma.weight", L + "2.to_gamma.bias",
                      L + "2.to_beta.weight", L + "2.to_beta.bias"]
            if model_cfg.attn_qk_norm:
                order += [L + "3.q_norm.gamma", L + "3.k_norm.gamma"]
            order += [L + "3.to_qkv.weight", L + "3.to_out.weight",
                      L + "4.to_gamma.weight", L + "4.to_gamma.bias",
                      L + "4.to_beta.weight", L + "4.to_beta.bias",
                      L + "5.0.weight", L + "5.0.bias",
                      L + "5.3.weight", L + "5.3.bias"]
        order += ["transformer.final_norm.gamma"]
    else:
        for i in range(model_cfg.convnext_layers):
            L = f"convnext.{i}."
            order += [L + "gamma",
                      L + "dwconv.weight", L + "dwconv.bias",
                      L + "norm.scale.weight", L + "norm.scale.bias",
                      L + "norm.shift.weight", L + "norm.shift.bias",
                      L + "pwconv1.weight", L + "pwconv1.bias",
                      L + "pwconv2.weight", L + "pwconv2.bias"]
        order += ["final_layer_norm.weight", "final_layer_norm.bias"]
    order += ["to_pred.weight"]
    return order


def optim_state_to_reference(net, adam: torch.optim.Optimizer, model_cfg,
                             train_cfg, step: int) -> dict:
    """The Adam moments of ``net``'s parameters in ``adam`` -> the
    reference's ``optimizer.state_dict()``: one param group over
    ``reference_param_order``, each entry's ``step`` = ``step`` (optimizer
    updates). ``null_cond`` is frozen in the reference (``requires_grad=
    False``), so it stays in the group with no state, as torch leaves it; a
    parameter the optimizer has not stepped yet gets zero moments."""
    order = reference_param_order(model_cfg)
    params = dict(net.named_parameters())
    groups = [{
        "lr": float(train_cfg.lr),
        "betas": (float(train_cfg.adam_b1), float(train_cfg.adam_b2)),
        "eps": float(train_cfg.adam_eps),
        "weight_decay": float(train_cfg.weight_decay),
        "amsgrad": False, "maximize": False, "foreach": None,
        "capturable": False, "differentiable": False, "fused": None,
        "params": list(range(len(order))),
    }]
    state = {}
    for idx, name in enumerate(order):
        if name == "null_cond":
            continue
        p = params[name]
        st = adam.state.get(p, {})
        state[idx] = {
            "step": torch.tensor(float(step)),
            "exp_avg": st.get("exp_avg", torch.zeros_like(p)).detach().cpu(),
            "exp_avg_sq": st.get("exp_avg_sq",
                                 torch.zeros_like(p)).detach().cpu(),
        }
    return {"state": state, "param_groups": groups}


def scheduler_state_to_reference(train_cfg, step: int, last_lr: float) -> dict:
    """The reference's ``CosineAnnealingLR(optim, T_max=num_train_steps)``
    state dict after ``step`` updates."""
    return {
        "T_max": int(train_cfg.num_train_steps),
        "eta_min": 0,
        "base_lrs": [float(train_cfg.lr)],
        "last_epoch": int(step),
        "verbose": False,
        "_step_count": int(step) + 1,
        "_get_lr_called_within_step": False,
        "_last_lr": [float(last_lr)],
    }
