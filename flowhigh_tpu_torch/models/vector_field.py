"""The CFM vector-field network ("FLowHigh" in the reference) — counterpart
of ``flowhigh_tpu/models/vector_field.py``.

concat(x_t, cond_mel) -> Linear -> depthwise ConvPositionEmbed residual ->
time-conditioned transformer -> Linear head. Parameter names are those of
the reference PyTorch ``FLowHigh`` state dict (without its ``flowhigh.``
prefix), so reference checkpoints load with no second mapping.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .transformer import ConvPositionEmbed, LearnedSinusoidalPosEmb, Transformer


class VectorFieldNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.architecture != "transformer":
            raise NotImplementedError(
                f"architecture {cfg.architecture!r} is not ported (ROADMAP.md "
                "queue 1 item 11(c))")
        if (cfg.num_register_tokens or cfg.use_unet_skip_connection
                or cfg.use_gateloop_layers):
            raise NotImplementedError(
                "register tokens, U-Net skips and GateLoop layers are not "
                "ported (ROADMAP.md queue 1 item 11(c))")
        self.cfg = cfg
        self.sinu_pos_emb = nn.Sequential(
            LearnedSinusoidalPosEmb(cfg.dim), nn.Linear(cfg.dim, cfg.dim),
            nn.SiLU())
        self.to_embed = nn.Linear(cfg.dim_in * 2, cfg.dim)
        self.null_cond = nn.Parameter(torch.zeros(cfg.dim_in),
                                      requires_grad=False)
        self.conv_embed = ConvPositionEmbed(cfg.dim,
                                            cfg.conv_pos_embed_kernel_size)
        self.transformer = Transformer(
            cfg.dim, cfg.depth, cfg.heads, cfg.dim_head, cfg.ff_mult,
            cfg.attn_qk_norm, cfg.attn_qk_norm_scale, cfg.rope_theta,
            attn_flash=cfg.attn_flash)
        self.to_pred = nn.Linear(cfg.dim, cfg.dim_in, bias=False)

    def forward(self, x: torch.Tensor, *, times: torch.Tensor,
                cond: torch.Tensor,
                cond_drop_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, cond: [B, T, dim_in]; times: [] or [B]; cond_drop_mask: [B]
        bool (True = null conditioning); mask: [B, T] bool (True = valid)."""
        b = x.shape[0]
        times = torch.as_tensor(times, dtype=torch.float32, device=x.device)
        if times.ndim == 0:
            times = times.expand(b)
        if cond_drop_mask is not None:
            cond = torch.where(cond_drop_mask[:, None, None], self.null_cond,
                               cond)
        h = self.to_embed(torch.cat([x, cond], dim=-1))
        h = self.conv_embed(h, mask) + h
        t_emb = self.sinu_pos_emb(times)
        h = self.transformer(h, t_emb, mask)
        return self.to_pred(h)


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
