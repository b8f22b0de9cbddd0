"""The CFM vector-field network ("FLowHigh" in the reference) — counterpart
of ``flowhigh_tpu/models/vector_field.py``.

concat(x_t, cond_mel) -> Linear -> depthwise ConvPositionEmbed residual ->
time-conditioned backbone (``cfg.architecture``: the transformer, with its
options, or ConvNeXt and a final LayerNorm) -> Linear head. Parameter names
are those of the reference PyTorch ``FLowHigh`` state dict (without its
``flowhigh.`` prefix), so reference checkpoints load with no second
mapping.

``cfg.compute_dtype`` ("float32" or "bfloat16") is the JAX package's
compute dtype, with its cast points: ``to_embed``, ``conv_embed`` and the
backbone's Linears and convs at that dtype (the residual stream in it);
norms, RoPE, softmax and GELU in float32, cast back; the time embedding
and ``to_pred`` in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .convnext import ConvNeXtBackbone
from .transformer import (ConvPositionEmbed, LearnedSinusoidalPosEmb,
                          Transformer, dense)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VectorFieldNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.architecture not in ("transformer", "convnext"):
            raise ValueError(f"unknown architecture: {cfg.architecture}")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, got "
                             f"{cfg.compute_dtype!r}")
        self.cfg = cfg
        self.dtype = dt = COMPUTE_DTYPES[cfg.compute_dtype]
        self.sinu_pos_emb = nn.Sequential(
            LearnedSinusoidalPosEmb(cfg.dim), nn.Linear(cfg.dim, cfg.dim),
            nn.SiLU())
        self.to_embed = nn.Linear(cfg.dim_in * 2, cfg.dim)
        self.null_cond = nn.Parameter(torch.zeros(cfg.dim_in),
                                      requires_grad=False)
        self.conv_embed = ConvPositionEmbed(
            cfg.dim, cfg.conv_pos_embed_kernel_size, dt)
        if cfg.architecture == "transformer":
            self.transformer = Transformer(
                cfg.dim, cfg.depth, cfg.heads, cfg.dim_head, cfg.ff_mult,
                cfg.attn_qk_norm, cfg.attn_qk_norm_scale, cfg.rope_theta,
                attn_flash=cfg.attn_flash,
                num_register_tokens=cfg.num_register_tokens,
                use_unet_skip_connection=cfg.use_unet_skip_connection,
                skip_connect_scale=cfg.skip_connect_scale,
                use_gateloop_layers=cfg.use_gateloop_layers, dtype=dt,
                attn_dropout=cfg.attn_dropout, ff_dropout=cfg.ff_dropout)
        else:
            self.convnext = ConvNeXtBackbone(cfg.dim, cfg.convnext_layers,
                                             cfg.convnext_mult, dt)
            self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.to_pred = nn.Linear(cfg.dim, cfg.dim_in, bias=False)

    def forward(self, x: torch.Tensor, *, times: torch.Tensor,
                cond: torch.Tensor,
                cond_drop_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x, cond: [B, T, dim_in]; times: [] or [B]; cond_drop_mask: [B]
        bool (True = null conditioning); mask: [B, T] bool (True = valid;
        the ConvNeXt backbone ignores it, as the JAX package's does);
        ``generator`` draws the transformer's dropout masks in train
        mode."""
        b = x.shape[0]
        times = torch.as_tensor(times, dtype=torch.float32, device=x.device)
        if times.ndim == 0:
            times = times.expand(b)
        if cond_drop_mask is not None:
            cond = torch.where(cond_drop_mask[:, None, None], self.null_cond,
                               cond)
        h = dense(self.to_embed, torch.cat([x, cond], dim=-1), self.dtype)
        h = self.conv_embed(h, mask) + h
        t_emb = self.sinu_pos_emb(times)
        if self.cfg.architecture == "transformer":
            h = self.transformer(h, t_emb, mask, generator)
        else:
            h = self.convnext(h, t_emb)
            h = self.final_layer_norm(h.float()).to(h.dtype)
        return self.to_pred(h.float())


def forward_with_cond_scale(net: VectorFieldNet, x, *, times, cond,
                            cond_scale: float = 1.0, mask=None) -> torch.Tensor:
    """CFG mixing null + (cond - null) * scale; one forward when scale is 1,
    otherwise the conditional and null branches share one batched forward."""
    if cond_scale == 1.0:
        return net(x, times=times, cond=cond, mask=mask)
    b = x.shape[0]
    times = torch.as_tensor(times, dtype=torch.float32, device=x.device)
    if times.ndim == 0:
        times = times.expand(b)
    drop = torch.cat([torch.zeros(b, dtype=torch.bool, device=x.device),
                      torch.ones(b, dtype=torch.bool, device=x.device)])
    out = net(torch.cat([x, x]), times=torch.cat([times, times]),
              cond=torch.cat([cond, cond]), cond_drop_mask=drop,
              mask=None if mask is None else torch.cat([mask, mask]))
    logits, null_logits = out[:b], out[b:]
    return null_logits + (logits - null_logits) * cond_scale
