"""Voicebox-style transformer backbone of the CFM vector field — counterpart
of ``flowhigh_tpu/models/transformer.py``, with its options: register
tokens, U-Net skip connections and GateLoop layers.

Module and parameter names follow the reference PyTorch layout (the state
dict of ``FLowHigh.transformer``): ``register_tokens``, and per layer ``i``
a ``ModuleList`` whose slots 0..5 hold the skip combiner (second-half
layers under U-Net skips), the GateLoop layer, attn-norm, attention,
ff-norm and the GEGLU feed-forward; an unused slot is an ``nn.Identity``.
The attention is a dense matmul-softmax-matmul with a key-padding mask, or,
with ``attn_flash`` (long-form), the blockwise kernel F
(``ops.flash_attention``) at O(N) memory. In ``train()`` mode
``attn_dropout`` drops attention probabilities after the softmax (dense
path only: flash is taken when the rate is 0 or the module is in eval
mode, as in the JAX package) and ``ff_dropout`` the GEGLU output before
the feed-forward's second Linear; each mask is drawn from the
``generator`` passed down through ``forward``.

``dtype`` is the JAX package's compute dtype (``ModelConfig.compute_dtype``)
with its cast points: the Linear layers take their inputs, weights and
biases in ``dtype``; norms, RoPE, softmax and the GateLoop recurrence run in
float32 and cast back; the two attention products are float32 products of
the ``dtype`` values (JAX's ``preferred_element_type=float32``), and kernel
F takes float32 q, k and v.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention
from ..utils import cudnn_f32


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||2, eps), written as rsqrt(max(ss, eps^2))."""
    ss = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(ss, min=eps * eps))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` at ``dtype``, as flax's ``Dense(dtype=...)``: input, weight
    and bias cast to ``dtype``; below float32 the product is rounded to
    ``dtype`` before the bias is added (in ``dtype``), as XLA computes it.
    At float32 it is the layer's own call, with no cast."""
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def depthwise_conv(conv: nn.Conv1d, x: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """[B, T, C] -> [B, C, T]: the depthwise ``conv`` at ``dtype``, then its
    float32 bias, as the JAX package adds a float32 bias to the
    ``dtype`` conv (which promotes the sum to float32). At float32 it is
    the conv's own call."""
    x = x.transpose(1, 2)
    with cudnn_f32():
        if dtype == torch.float32:
            return conv(x)
        y = F.conv1d(x.to(dtype), conv.weight.to(dtype), None,
                     padding=conv.padding, groups=conv.groups)
    return y + conv.bias[:, None]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: each element kept where a uniform draw from
    ``generator`` (torch's default generator when None) falls below
    1 - ``rate``, and scaled by 1 / (1 - rate); all zero at rate 1."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def rotary_freqs(seq_len: int, dim_head: int, theta: float = 50000.0,
                 device=None, positions=None) -> torch.Tensor:
    """[seq, dim_head] rotary angle table with duplicated halves (f64 on the
    host, then f32). ``positions`` replaces arange(seq_len): register
    tokens sit at -10000."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64)
                                / dim_head))
    t = (np.asarray(positions, dtype=np.float64) if positions is not None
         else np.arange(seq_len, dtype=np.float64))
    freqs = np.einsum("i,j->ij", t, inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def apply_rotary(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t * cos(pos) + rotate_half(t) * sin(pos), in float32, cast back."""
    if t.dtype != torch.float32:
        return apply_rotary(pos, t.float()).to(t.dtype)
    half = t.shape[-1] // 2
    rotated = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * torch.cos(pos) + rotated * torch.sin(pos)


class RMSNorm(nn.Module):
    """normalize(x) * sqrt(dim) * gamma, in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        return l2norm(x) * self.scale * self.gamma


class AdaptiveRMSNorm(nn.Module):
    """Time-conditioned RMSNorm (identity at init: to_gamma bias 1, rest 0),
    in float32."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.to_gamma = nn.Linear(cond_dim, dim)
        self.to_beta = nn.Linear(cond_dim, dim)
        nn.init.zeros_(self.to_gamma.weight)
        nn.init.ones_(self.to_gamma.bias)
        nn.init.zeros_(self.to_beta.weight)
        nn.init.zeros_(self.to_beta.bias)

    def forward(self, x, cond):  # cond: the float32 time embedding
        if x.dtype != torch.float32:
            return self.forward(x.float(), cond).to(x.dtype)
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
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        return l2norm(x) * self.gamma * self.scale


class Attention(nn.Module):
    """Fused-QKV multi-head attention with qk-norm (scale 10) and RoPE.
    ``use_flash`` routes the scores through ``ops.flash_attention`` (kernel
    F; O(N) memory, the JAX package's segment-id padding semantics for
    masked rows) instead of the dense path, unless ``dropout`` is active
    (train mode, rate > 0); it has no parameters of its own."""

    def __init__(self, dim: int, heads: int = 16, dim_head: int = 64,
                 qk_norm: bool = True, qk_norm_scale: float = 10.0,
                 use_flash: bool = False, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.use_flash, self.dtype, self.dropout = use_flash, dtype, dropout
        inner = heads * dim_head
        self.qk_norm = qk_norm
        self.scale = qk_norm_scale if qk_norm else dim_head ** -0.5
        if qk_norm:
            self.q_norm = MultiheadRMSNorm(dim_head, heads)
            self.k_norm = MultiheadRMSNorm(dim_head, heads)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, rotary, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        dt = self.dtype
        q, k, v = dense(self.to_qkv, x, dt).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rotary(rotary, q), apply_rotary(rotary, k)
        lowp = dt != torch.float32
        if lowp:  # float32 products of the dt values
            q, k, v = q.float(), k.float(), v.float()
        drop = self.training and self.dropout > 0.0
        if self.use_flash and not drop:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), mask, self.scale)
        else:
            sim = torch.matmul(q, k.transpose(-1, -2)) * self.scale
            if mask is not None:  # key padding [B, N], True = keep
                sim = sim.masked_fill(~mask[:, None, None, :],
                                      torch.finfo(sim.dtype).min)
            attn = sim.softmax(dim=-1)
            if lowp:  # the probabilities round to dt before AV
                attn = attn.to(dt)
            if drop:
                attn = dropout(attn, self.dropout, generator)
            out = torch.matmul(attn.float() if lowp else attn, v)
        if lowp:
            out = out.to(dt)
        return dense(self.to_out, out.transpose(1, 2).reshape(b, n, -1), dt)


class GEGLU(nn.Module):
    def forward(self, x):
        x, gate = x.chunk(2, dim=-1)
        if gate.dtype != torch.float32:  # the GELU in float32, cast back
            return gelu_exact(gate.float()).to(x.dtype) * x
        return gelu_exact(gate) * x


class FeedForward(nn.Sequential):
    """GEGLU feed-forward, inner dim int(dim*mult*2/3); slots 0 and 3 hold
    the weights, as in the reference layout, whose slot 2 is the dropout
    (``dropout``, in train mode) between them."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        inner = int(dim * mult * 2 / 3)
        super().__init__(nn.Linear(dim, inner * 2), GEGLU(), nn.Identity(),
                         nn.Linear(inner, dim))
        self.dtype, self.dropout = dtype, dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self[1](dense(self[0], x, self.dtype))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, generator)
        return dense(self[3], h, self.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s_t = a_t * s_{t-1} + b_t along dim 1 (s_{-1} = 0), as the JAX
    package's ``lax.associative_scan`` with the combine
    (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2): a doubling (Hillis-Steele)
    pass, ceil(log2 T) steps of whole-tensor operations (10 at 1,000 frames,
    15 at 30,000). Each step combines every element with the one 2^j before
    it, so the products and sums group in another order than
    ``lax.associative_scan``'s: equal in exact arithmetic, not in float32
    bits."""
    n, k = a.shape[1], 1
    while k < n:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


class GateLoop(nn.Module):
    """The JAX package's GateLoop layer (the SimpleGateLoopLayer of
    arXiv:2311.01927): RMSNorm, the fused ``to_qkva`` projection (no bias)
    at ``dtype``, then in float32 a sigmoid transition a, the recurrence
    s_t = a_t s_{t-1} + k_t v_t (``linear_scan``), q * s, and ``post_ln``
    (LayerNorm, eps 1e-6 as flax's), cast back. The caller adds the
    residual. Causal: frame t reads frames <= t only."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = RMSNorm(dim)
        self.to_qkva = nn.Linear(dim, dim * 4, bias=False)
        self.post_ln = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        qkva = dense(self.to_qkva, self.norm(x), self.dtype).float()
        q, k, v, a = qkva.chunk(4, dim=-1)
        s = linear_scan(torch.sigmoid(a), k * v)
        return self.post_ln(q * s).to(x.dtype)


class Transformer(nn.Module):
    """Pre-norm transformer with adaptive RMSNorm time conditioning and the
    reference's options: ``num_register_tokens`` learned tokens prepended
    at rotary position -10000 (the key-padding mask padded True for them)
    and stripped before ``final_norm``; U-Net skips (``depth`` even: the
    first half's inputs, scaled by ``skip_connect_scale``, default 2^-0.5,
    joined to the second half's by a Linear(2 dim, dim) combiner in slot
    0); GateLoop layers (slot 1) before each attention, residual added;
    ``attn_dropout`` and ``ff_dropout`` in train mode."""

    def __init__(self, dim: int, depth: int, heads: int = 16, dim_head: int = 64,
                 ff_mult: int = 4, qk_norm: bool = True,
                 qk_norm_scale: float = 10.0, rope_theta: float = 50000.0,
                 attn_flash: bool = False, num_register_tokens: int = 0,
                 use_unet_skip_connection: bool = False,
                 skip_connect_scale: Optional[float] = None,
                 use_gateloop_layers: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__()
        if use_unet_skip_connection and depth % 2:
            raise ValueError(f"U-Net skip connections need an even depth, "
                             f"got {depth}")
        self.dim_head, self.rope_theta, self.dtype = dim_head, rope_theta, dtype
        self.num_register_tokens = num_register_tokens
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.randn(num_register_tokens, dim))
        self.use_unet = use_unet_skip_connection
        # the scale in ``dtype``, as JAX casts a Python float to the array's
        self.skip_scale = float(torch.tensor(
            2.0 ** -0.5 if skip_connect_scale is None else skip_connect_scale,
            dtype=dtype))
        self.use_gateloop = use_gateloop_layers
        self.layers = nn.ModuleList([
            nn.ModuleList([
                nn.Linear(dim * 2, dim)
                if use_unet_skip_connection and i >= depth // 2
                else nn.Identity(),
                GateLoop(dim, dtype) if use_gateloop_layers else nn.Identity(),
                AdaptiveRMSNorm(dim, dim),
                Attention(dim, heads, dim_head, qk_norm, qk_norm_scale,
                          use_flash=attn_flash, dtype=dtype,
                          dropout=attn_dropout),
                AdaptiveRMSNorm(dim, dim),
                FeedForward(dim, ff_mult, dtype, ff_dropout),
            ]) for i in range(depth)])
        self.final_norm = RMSNorm(dim)

    def forward(self, x, time_emb, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, n = x.shape[:2]
        r = self.num_register_tokens
        positions = None
        if r > 0:
            reg = self.register_tokens.to(x.dtype).expand(b, -1, -1)
            x = torch.cat([reg, x], dim=1)
            if mask is not None:
                mask = torch.cat([mask.new_ones(b, r), mask], dim=1)
            positions = np.concatenate([np.full(r, -10000.0), np.arange(n)])
        rotary = rotary_freqs(n + r, self.dim_head, self.rope_theta, x.device,
                              positions)
        skips = []
        for skip_combiner, gateloop, attn_norm, attn, ff_norm, ff in self.layers:
            if self.use_unet and isinstance(skip_combiner, nn.Identity):
                skips.append(x)
            elif self.use_unet:
                skip = skips.pop() * self.skip_scale
                x = dense(skip_combiner, torch.cat([x, skip], dim=-1),
                          self.dtype)
            if self.use_gateloop:
                x = gateloop(x) + x
            x = attn(attn_norm(x, time_emb), rotary, mask, generator) + x
            x = ff(ff_norm(x, time_emb), generator) + x
        if r > 0:
            x = x[:, r:]
        return self.final_norm(x)


class ConvPositionEmbed(nn.Module):
    """Depthwise conv positional embedding (kernel 31) + exact GELU, on
    [B, T, C]; padded frames are zeroed before and after. The conv runs at
    ``dtype`` (``depthwise_conv``), the GELU in float32."""

    def __init__(self, dim: int, kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvPositionEmbed needs an odd kernel size")
        self.dtype = dtype
        self.dw_conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=dim,
                      padding=kernel_size // 2),
            nn.GELU())

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        conv, gelu = self.dw_conv1d  # the conv's output is float32
        y = gelu(depthwise_conv(conv, x, self.dtype)).transpose(1, 2)
        y = y.to(x.dtype)
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
