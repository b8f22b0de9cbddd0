"""The vector field ("FLowHigh" of the reference's flow.py) in plain PyTorch.

Written from the reference's formulas (a voicebox-style transformer):
concat(x, cond) -> Linear -> depthwise conv position embedding (kernel 31,
exact GELU) as a residual -> pre-norm transformer (adaptive RMSNorm from the
sinusoidal time embedding, multi-head attention with per-head RMSNorm on q
and k, scale 10, rotary embedding theta 50,000, GEGLU feed-forward of inner
width int(dim * mult * 2 / 3)) -> RMSNorm -> Linear head. A key-padding mask
(True = a valid frame) keeps padded frames out of every attention row, and
the position embedding zeroes them before and after its conv. The state-dict
keys are the reference checkpoint's (without its ``flowhigh.`` prefix).

Everything is float32. ``dot`` is the one place where a lower precision may
stand in for the control (see ``precision.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .precision import linear


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)


class SinusoidalTime(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(dim // 2))

    def forward(self, t):
        freqs = t[:, None] * self.weights[None, :] * (2 * math.pi)
        return torch.cat([freqs.sin(), freqs.cos()], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return l2norm(x) * x.shape[-1] ** 0.5 * self.gamma


class AdaptiveRMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_gamma = nn.Linear(dim, dim)
        self.to_beta = nn.Linear(dim, dim)

    def forward(self, x, t_emb, quant):
        g = linear(t_emb, self.to_gamma.weight, self.to_gamma.bias, quant)
        b = linear(t_emb, self.to_beta.weight, self.to_beta.bias, quant)
        return l2norm(x) * x.shape[-1] ** 0.5 * g[:, None] + b[:, None]


class HeadNorm(nn.Module):
    def __init__(self, heads: int, dim_head: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(heads, 1, dim_head))

    def forward(self, x):
        return l2norm(x) * x.shape[-1] ** 0.5 * self.gamma


def rotary(n: int, dim_head: int, theta: float, device) -> torch.Tensor:
    inv = 1.0 / theta ** (torch.arange(0, dim_head, 2, dtype=torch.float64)
                          / dim_head)
    f = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([f, f], dim=-1).float().to(device)


def rotate(x, pos):
    x1, x2 = x.chunk(2, dim=-1)
    return x * pos.cos() + torch.cat([-x2, x1], dim=-1) * pos.sin()


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, scale: float):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.q_norm = HeadNorm(heads, dim_head)
        self.k_norm = HeadNorm(heads, dim_head)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)

    def forward(self, x, pos, mask, quant):
        b, n, _ = x.shape
        qkv = linear(x, self.to_qkv.weight, None, quant)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        q, k = rotate(self.q_norm(q), pos), rotate(self.k_norm(k), pos)
        sim = linear(q, k, None, quant) * self.scale
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :], float("-inf"))
        out = linear(sim.softmax(dim=-1), v.transpose(-1, -2), None, quant)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return linear(out, self.to_out.weight, None, quant)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.l0 = nn.Linear(dim, 2 * inner)
        self.l3 = nn.Linear(inner, dim)

    def forward(self, x, quant):
        h, gate = linear(x, self.l0.weight, self.l0.bias, quant).chunk(2, -1)
        return linear(F.gelu(gate) * h, self.l3.weight, self.l3.bias, quant)


class Layer(nn.Module):
    def __init__(self, dim, heads, dim_head, mult, scale):
        super().__init__()
        self.attn_norm = AdaptiveRMSNorm(dim)
        self.attn = Attention(dim, heads, dim_head, scale)
        self.ff_norm = AdaptiveRMSNorm(dim)
        self.ff = FeedForward(dim, mult)


class VectorField(nn.Module):
    """``model``: the configuration file's ``model`` group (dim_in, dim,
    depth, heads, dim_head, ff_mult, conv_pos_embed_kernel_size,
    attn_qk_norm_scale, rope_theta)."""

    def __init__(self, model: dict):
        super().__init__()
        dim, dim_in = model["dim"], model["dim_in"]
        self.theta = float(model["rope_theta"])
        self.dim_head = model["dim_head"]
        self.sinu = SinusoidalTime(dim)
        self.time_mlp = nn.Linear(dim, dim)
        self.to_embed = nn.Linear(2 * dim_in, dim)
        self.null_cond = nn.Parameter(torch.zeros(dim_in))
        k = model["conv_pos_embed_kernel_size"]
        self.conv = nn.Conv1d(dim, dim, k, groups=dim, padding=k // 2)
        self.layers = nn.ModuleList([
            Layer(dim, model["heads"], model["dim_head"], model["ff_mult"],
                  float(model["attn_qk_norm_scale"]))
            for _ in range(model["depth"])])
        self.final_norm = RMSNorm(dim)
        self.to_pred = nn.Linear(dim, dim_in, bias=False)
        self.quant = None  # the control's rounding of every product's inputs

    def forward(self, x, times, cond, mask=None):
        q = self.quant
        b, n, _ = x.shape
        t_emb = F.silu(linear(self.sinu(times), self.time_mlp.weight,
                              self.time_mlp.bias, q))
        h = linear(torch.cat([x, cond], dim=-1), self.to_embed.weight,
                   self.to_embed.bias, q)
        keep = None if mask is None else mask[..., None]
        hc = h if keep is None else h.masked_fill(~keep, 0.0)
        pe = F.gelu(self.conv(hc.transpose(1, 2))).transpose(1, 2)
        h = h + (pe if keep is None else pe.masked_fill(~keep, 0.0))
        pos = rotary(n, self.dim_head, self.theta, x.device)
        for layer in self.layers:
            h = layer.attn(layer.attn_norm(h, t_emb, q), pos, mask, q) + h
            h = layer.ff(layer.ff_norm(h, t_emb, q), q) + h
        return linear(self.final_norm(h), self.to_pred.weight, None, q)


def state_key(name: str) -> str:
    """This module's parameter name -> the reference checkpoint's."""
    for mine, ref in (("sinu.weights", "sinu_pos_emb.0.weights"),
                      ("time_mlp.", "sinu_pos_emb.1."),
                      ("conv.", "conv_embed.dw_conv1d.0."),
                      ("layers.", "transformer.layers."),
                      ("final_norm.", "transformer.final_norm."),
                      (".attn_norm.", ".2."), (".attn.", ".3."),
                      (".ff_norm.", ".4."), (".ff.l0.", ".5.0."),
                      (".ff.l3.", ".5.3.")):
        name = name.replace(mine, ref)
    return name


def load_reference_state(net: VectorField, sd: dict) -> VectorField:
    """Load a reference-layout state dict (``flowhigh.`` prefix optional)."""
    sd = {k.removeprefix("flowhigh."): v for k, v in sd.items()}
    own = dict(net.named_parameters())
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(sd[state_key(name)])
    return net
