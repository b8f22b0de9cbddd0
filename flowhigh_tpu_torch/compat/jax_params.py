"""Weights across: the JAX package's param trees -> this package's state
dicts, and a seeded init for runs without a checkpoint.

The trees are nested dicts of numpy arrays (``jax.device_get`` of the flax
params, with or without the top ``"params"`` level); nothing here imports
JAX. The mapping is this package's own copy of the JAX package's torch
export (``flowhigh_tpu/compat/torch_ckpt.py``: ``params_to_torch_state`` and
``vocoder_params_to_torch_state`` with ``fold_weight_norm``, and
``_disc_to_torch`` for the discriminators). Layouts:

- Dense kernel ``[in, out]``      -> Linear ``[out, in]`` (transpose)
- Conv HIO kernel ``[K, in/g, out]`` -> Conv1d ``[out, in/g, K]`` (perm 2,1,0)
- transpose-conv ``[K, out, in]`` -> ConvTranspose1d ``[in, out, K]`` (perm 2,1,0)
- Conv2d HWIO ``[kH, kW, in, out]`` -> OIHW ``[out, in, kH, kW]`` (perm 3,2,0,1)
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, VocoderConfig
from ..models.bigvgan import kaiser_sinc_filter1d
from ..models.transformer import LearnedSinusoidalPosEmb, Transformer


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _tree(params: dict) -> dict:
    return params["params"] if "params" in params else params


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = g * v / ||v||, norm over all dims except 0 (torch weight_norm dim=0)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return (g / norm) * v


def fold_state_dict(sd: dict) -> dict:
    """Replace every ``X.weight_g``/``X.weight_v`` pair of a reference
    (weight-normed) state dict by the folded ``X.weight``."""
    out = {}
    for key, val in sd.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            out[base + ".weight"] = torch.from_numpy(fold_weight_norm(
                _np(sd[base + ".weight_g"]), _np(val)))
        else:
            out[key] = torch.tensor(_np(val))
    return out


def vector_field_state_from_jax(params: dict, cfg: ModelConfig) -> dict:
    """JAX ``VectorFieldNet`` params (either backbone, with the transformer's
    register tokens, skip combiners and GateLoop layers) -> ``VectorFieldNet``
    state dict."""
    p = _tree(params)
    sd = {
        "null_cond": _np(p["null_cond"]),
        "to_embed.weight": _np(p["to_embed"]["kernel"]).T,
        "to_embed.bias": _np(p["to_embed"]["bias"]),
        "conv_embed.dw_conv1d.0.weight":
            _np(p["conv_embed"]["kernel"]).transpose(2, 1, 0),
        "conv_embed.dw_conv1d.0.bias": _np(p["conv_embed"]["bias"]),
        "sinu_pos_emb.0.weights": _np(p["sinu_pos_emb"]["weights"]),
        "sinu_pos_emb.1.weight": _np(p["time_mlp"]["kernel"]).T,
        "sinu_pos_emb.1.bias": _np(p["time_mlp"]["bias"]),
        "to_pred.weight": _np(p["to_pred"]["kernel"]).T,
    }
    if cfg.architecture == "convnext":
        cn = p["convnext"]
        for i in range(cfg.convnext_layers):
            blk, L = cn[f"blocks_{i}"], f"convnext.{i}."
            sd[L + "dwconv.weight"] = _np(blk["dwconv_kernel"]).transpose(2, 1, 0)
            sd[L + "dwconv.bias"] = _np(blk["dwconv_bias"])
            for part in ("scale", "shift"):
                sd[f"{L}norm.{part}.weight"] = _np(blk["norm"][part]["kernel"]).T
                sd[f"{L}norm.{part}.bias"] = _np(blk["norm"][part]["bias"])
            for part in ("pwconv1", "pwconv2"):
                sd[f"{L}{part}.weight"] = _np(blk[part]["kernel"]).T
                sd[f"{L}{part}.bias"] = _np(blk[part]["bias"])
            sd[L + "gamma"] = _np(blk["gamma"])
        sd["final_layer_norm.weight"] = _np(cn["final_norm_scale"])
        sd["final_layer_norm.bias"] = _np(cn["final_norm_bias"])
        return {k: torch.tensor(v) for k, v in sd.items()}
    tr = p["transformer"]
    if "register_tokens" in tr:
        sd["transformer.register_tokens"] = _np(tr["register_tokens"])
    for i in range(cfg.depth):
        L = f"transformer.layers.{i}."
        if f"layers_{i}_skip_combiner" in tr:  # slot 0
            sk = tr[f"layers_{i}_skip_combiner"]
            sd[L + "0.weight"] = _np(sk["kernel"]).T
            sd[L + "0.bias"] = _np(sk["bias"])
        if f"layers_{i}_gateloop" in tr:  # slot 1
            gl = tr[f"layers_{i}_gateloop"]
            sd[L + "1.norm.gamma"] = _np(gl["norm"]["gamma"])
            sd[L + "1.to_qkva.weight"] = _np(gl["to_qkva"]["kernel"]).T
            sd[L + "1.post_ln.weight"] = _np(gl["post_ln"]["scale"])
            sd[L + "1.post_ln.bias"] = _np(gl["post_ln"]["bias"])
        an, at = tr[f"layers_{i}_attn_norm"], tr[f"layers_{i}_attn"]
        fn, ff = tr[f"layers_{i}_ff_norm"], tr[f"layers_{i}_ff"]
        for slot, norm in (("2", an), ("4", fn)):
            for part in ("to_gamma", "to_beta"):
                sd[f"{L}{slot}.{part}.weight"] = _np(norm[part]["kernel"]).T
                sd[f"{L}{slot}.{part}.bias"] = _np(norm[part]["bias"])
        sd[L + "3.to_qkv.weight"] = _np(at["to_qkv"]["kernel"]).T
        sd[L + "3.to_out.weight"] = _np(at["to_out"]["kernel"]).T
        if "q_norm" in at:
            sd[L + "3.q_norm.gamma"] = _np(at["q_norm"]["gamma"])
            sd[L + "3.k_norm.gamma"] = _np(at["k_norm"]["gamma"])
        sd[L + "5.0.weight"] = _np(ff["proj_in"]["kernel"]).T
        sd[L + "5.0.bias"] = _np(ff["proj_in"]["bias"])
        sd[L + "5.3.weight"] = _np(ff["proj_out"]["kernel"]).T
        sd[L + "5.3.bias"] = _np(ff["proj_out"]["bias"])
    sd["transformer.final_norm.gamma"] = _np(tr["final_norm"]["gamma"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def vocoder_state_from_jax(params: dict, cfg: VocoderConfig) -> dict:
    """JAX ``BigVGAN`` params (resblock "1" or "2") -> ``BigVGAN`` state
    dict: first the reference's weight-normed layout (``weight_v = w``, ``weight_g = |w|``,
    as the JAX package exports it), then folded, plus the alias-free filter
    buffers the reference modules carry."""
    p = _tree(params)
    nk = len(cfg.resblock_kernel_sizes)
    sd: dict = {}
    filt = kaiser_sinc_filter1d(0.25, 0.3, 12).reshape(1, 1, 12)

    def put_conv(base: str, kernel, bias):
        w = np.ascontiguousarray(_np(kernel).transpose(2, 1, 0))
        sd[base + ".weight_g"] = np.sqrt(
            np.sum(w * w, axis=tuple(range(1, w.ndim)), keepdims=True))
        sd[base + ".weight_v"] = w
        sd[base + ".bias"] = _np(bias)

    def put_act(base: str, act: dict):
        sd[base + ".upsample.filter"] = filt
        sd[base + ".act.alpha"] = _np(act["alpha"])
        if cfg.activation == "snakebeta":
            sd[base + ".act.beta"] = _np(act["beta"])
        sd[base + ".downsample.filter"] = filt

    put_conv("conv_pre", p["conv_pre_kernel"], p["conv_pre_bias"])
    for i in range(len(cfg.upsample_rates)):
        put_conv(f"ups.{i}.0", p[f"ups_{i}_kernel"], p[f"ups_{i}_bias"])
    for n in range(len(cfg.upsample_rates) * nk):
        blk, B = p[f"resblocks_{n}"], f"resblocks.{n}"
        for j in range(len(cfg.resblock_dilation_sizes[n % nk])):
            if cfg.resblock == "2":  # AMPBlock2: act_j -> convs_j
                put_conv(f"{B}.convs.{j}", blk[f"convs_{j}_kernel"],
                         blk[f"convs_{j}_bias"])
                put_act(f"{B}.activations.{j}", blk[f"act_{j}"])
                continue
            put_conv(f"{B}.convs1.{j}", blk[f"convs1_{j}_kernel"],
                     blk[f"convs1_{j}_bias"])
            put_conv(f"{B}.convs2.{j}", blk[f"convs2_{j}_kernel"],
                     blk[f"convs2_{j}_bias"])
            put_act(f"{B}.activations.{2 * j}", blk[f"act1_{j}"])
            put_act(f"{B}.activations.{2 * j + 1}", blk[f"act2_{j}"])
    put_act("activation_post", p["activation_post"])
    put_conv("conv_post", p["conv_post_kernel"], p["conv_post_bias"])
    return fold_state_dict(sd)


# the discriminators' convs (weight norm kept as g and v): HWIO ``*_v`` ->
# OIHW ``weight_v``, ``*_g`` [O] -> ``weight_g`` [O, 1, 1, 1]
_DISC_CONVS = tuple((f"convs.{j}", f"convs_{j}") for j in range(5)) + (
    ("conv_post", "conv_post"),)


def _disc_state(p: dict, base: str, sd: dict) -> None:
    for mod, name in _DISC_CONVS:
        sd[f"{base}.{mod}.bias"] = _np(p[f"{name}_bias"])
        sd[f"{base}.{mod}.weight_g"] = _np(p[f"{name}_g"]).reshape(-1, 1, 1, 1)
        sd[f"{base}.{mod}.weight_v"] = np.ascontiguousarray(
            _np(p[f"{name}_v"]).transpose(3, 2, 0, 1))


def mpd_state_from_jax(params: dict, periods=(2, 3, 5, 7, 11)) -> dict:
    """JAX ``MultiPeriodDiscriminator`` params (one ``p{period}`` tree a
    period) -> ``MultiPeriodDiscriminator`` state dict (the reference's
    ``discriminators.{i}`` layout)."""
    p, sd = _tree(params), {}
    for i, per in enumerate(periods):
        _disc_state(p[f"p{per}"], f"discriminators.{i}", sd)
    return {k: torch.tensor(v) for k, v in sd.items()}


def mrd_state_from_jax(params: dict,
                       resolutions=((1024, 120, 600), (2048, 240, 1200),
                                    (512, 50, 240))) -> dict:
    """JAX ``MultiResolutionDiscriminator`` params (one ``r{n_fft}`` tree a
    resolution) -> ``MultiResolutionDiscriminator`` state dict."""
    p, sd = _tree(params), {}
    for i, res in enumerate(resolutions):
        _disc_state(p[f"r{res[0]}"], f"discriminators.{i}", sd)
    return {k: torch.tensor(v) for k, v in sd.items()}


def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """In-place init from ``numpy.random.default_rng(seed)``:
    every >= 2-D Linear/Conv weight gets fan-in-scaled normals
    N(0, 1/fan_in) with fan_in = prod(shape[1:]); the sinusoidal time
    embedding's frequencies and the register tokens get unit normals;
    Linear/Conv biases are 0 except the adaptive norms' gain biases
    (``to_gamma``, ConvNeXt's ``norm.scale``: 1, identity at init); every
    other parameter (norm gains 1, ConvNeXt's layer scale 1, snake
    log-alpha/log-beta 0, null_cond 0) keeps its module's init."""
    rng = np.random.default_rng(seed)
    layers = (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            if isinstance(mod, LearnedSinusoidalPosEmb):
                mod.weights.copy_(torch.from_numpy(
                    rng.standard_normal(mod.weights.shape, dtype=np.float32)))
            if isinstance(mod, Transformer) and mod.num_register_tokens:
                reg = mod.register_tokens
                reg.copy_(torch.from_numpy(
                    rng.standard_normal(reg.shape, dtype=np.float32)))
            if not isinstance(mod, layers):
                continue
            w = mod.weight
            std = float(np.prod(w.shape[1:])) ** -0.5
            w.copy_(torch.from_numpy(
                rng.standard_normal(w.shape, dtype=np.float32) * std))
            if mod.bias is not None:
                in_ada_gamma = mod_name.endswith(("to_gamma", "norm.scale"))
                mod.bias.fill_(1.0 if in_ada_gamma else 0.0)
    return module


__all__ = ["fold_weight_norm", "fold_state_dict", "vector_field_state_from_jax",
           "vocoder_state_from_jax", "mpd_state_from_jax",
           "mrd_state_from_jax", "seeded_init_"]
