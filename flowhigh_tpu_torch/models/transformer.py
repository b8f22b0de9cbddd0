"""Voicebox-style transformer backbone of the CFM vector field — counterpart
of ``flowhigh_tpu/models/transformer.py`` (without register tokens, U-Net
skips or GateLoop layers).

Module and parameter names follow the reference PyTorch layout (the state
dict of ``FLowHigh.transformer``): layer ``i`` is a ``ModuleList`` whose
slots 2..5 hold attn-norm, attention, ff-norm and the GEGLU feed-forward
(slots 0 and 1 are the unused skip-combiner and GateLoop places). Norms,
softmax and RoPE run in float32; the attention is the plain einsum with a
key-padding mask.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import cudnn_f32


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||2, eps), written as rsqrt(max(ss, eps^2))."""
    ss = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(ss, min=eps * eps))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def rotary_freqs(seq_len: int, dim_head: int, theta: float = 50000.0,
                 device=None) -> torch.Tensor:
    """[seq, dim_head] rotary angle table with duplicated halves (f64 on the
    host, then f32)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64)
                                / dim_head))
    freqs = np.einsum("i,j->ij", np.arange(seq_len, dtype=np.float64), inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def apply_rotary(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t * cos(pos) + rotate_half(t) * sin(pos)."""
    half = t.shape[-1] // 2
    rotated = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * torch.cos(pos) + rotated * torch.sin(pos)


class RMSNorm(nn.Module):
    """normalize(x) * sqrt(dim) * gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return l2norm(x) * self.scale * self.gamma


class AdaptiveRMSNorm(nn.Module):
    """Time-conditioned RMSNorm (identity at init: to_gamma bias 1, rest 0)."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.to_gamma = nn.Linear(cond_dim, dim)
        self.to_beta = nn.Linear(cond_dim, dim)
        nn.init.zeros_(self.to_gamma.weight)
        nn.init.ones_(self.to_gamma.bias)
        nn.init.zeros_(self.to_beta.weight)
        nn.init.zeros_(self.to_beta.bias)

    def forward(self, x, cond):
        gamma = self.to_gamma(cond)[:, None, :]
        beta = self.to_beta(cond)[:, None, :]
        return l2norm(x) * self.scale * gamma + beta


class MultiheadRMSNorm(nn.Module):
    """Per-head qk RMSNorm: learned gamma [heads, 1, dim_head], fixed sqrt(d)."""

    def __init__(self, dim_head: int, heads: int):
        super().__init__()
        self.scale = dim_head ** 0.5
        self.gamma = nn.Parameter(torch.ones(heads, 1, dim_head))

    def forward(self, x):  # [B, H, N, Dh]
        return l2norm(x) * self.gamma * self.scale


class Attention(nn.Module):
    """Fused-QKV multi-head attention with qk-norm (scale 10) and RoPE."""

    def __init__(self, dim: int, heads: int = 16, dim_head: int = 64,
                 qk_norm: bool = True, qk_norm_scale: float = 10.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.qk_norm = qk_norm
        self.scale = qk_norm_scale if qk_norm else dim_head ** -0.5
        if qk_norm:
            self.q_norm = MultiheadRMSNorm(dim_head, heads)
            self.k_norm = MultiheadRMSNorm(dim_head, heads)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, rotary, mask: Optional[torch.Tensor] = None):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rotary(rotary, q), apply_rotary(rotary, k)
        sim = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:  # key padding [B, N], True = keep
            sim = sim.masked_fill(~mask[:, None, None, :],
                                  torch.finfo(sim.dtype).min)
        out = torch.matmul(sim.softmax(dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def forward(self, x):
        x, gate = x.chunk(2, dim=-1)
        return gelu_exact(gate) * x


def feed_forward(dim: int, mult: int = 4) -> nn.Sequential:
    """GEGLU feed-forward, inner dim int(dim*mult*2/3) (slots 0 and 3 hold
    the weights, as in the reference layout)."""
    inner = int(dim * mult * 2 / 3)
    return nn.Sequential(nn.Linear(dim, inner * 2), GEGLU(), nn.Identity(),
                         nn.Linear(inner, dim))


class Transformer(nn.Module):
    """Pre-norm transformer with adaptive RMSNorm time conditioning."""

    def __init__(self, dim: int, depth: int, heads: int = 16, dim_head: int = 64,
                 ff_mult: int = 4, qk_norm: bool = True,
                 qk_norm_scale: float = 10.0, rope_theta: float = 50000.0):
        super().__init__()
        self.dim_head, self.rope_theta = dim_head, rope_theta
        self.layers = nn.ModuleList([
            nn.ModuleList([
                nn.Identity(), nn.Identity(),
                AdaptiveRMSNorm(dim, dim),
                Attention(dim, heads, dim_head, qk_norm, qk_norm_scale),
                AdaptiveRMSNorm(dim, dim),
                feed_forward(dim, ff_mult),
            ]) for _ in range(depth)])
        self.final_norm = RMSNorm(dim)

    def forward(self, x, time_emb, mask: Optional[torch.Tensor] = None):
        rotary = rotary_freqs(x.shape[1], self.dim_head, self.rope_theta,
                              x.device)
        for _, _, attn_norm, attn, ff_norm, ff in self.layers:
            x = attn(attn_norm(x, time_emb), rotary, mask) + x
            x = ff(ff_norm(x, time_emb)) + x
        return self.final_norm(x)


class ConvPositionEmbed(nn.Module):
    """Depthwise conv positional embedding (kernel 31) + exact GELU, on
    [B, T, C]; padded frames are zeroed before and after."""

    def __init__(self, dim: int, kernel_size: int = 31):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvPositionEmbed needs an odd kernel size")
        self.dw_conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=dim,
                      padding=kernel_size // 2),
            nn.GELU())

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        with cudnn_f32():
            y = self.dw_conv1d(x.transpose(1, 2)).transpose(1, 2)
        if mask is not None:
            y = y.masked_fill(~mask[..., None], 0.0)
        return y


class LearnedSinusoidalPosEmb(nn.Module):
    """Random learned Fourier features of the scalar ODE time."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t):  # [B]
        freqs = t[:, None].float() * self.weights[None, :] * (2 * math.pi)
        return torch.cat([torch.sin(freqs), torch.cos(freqs)], dim=-1)
