"""1-D ConvNeXt backbone of the vector field (``architecture="convnext"``) —
counterpart of ``flowhigh_tpu/models/convnext.py``.

[B, T, C] in and out. Module names follow the reference layout
(``convnext.{i}.dwconv``, ``.norm.scale``, ``.norm.shift``, ``.pwconv1``,
``.pwconv2``, ``.gamma``; the final LayerNorm is the vector field's
top-level ``final_layer_norm``). ``dtype`` is the compute dtype with the
JAX package's cast points: the depthwise conv and the pointwise Linears at
``dtype``, the conv's bias, the norms and the GELU in float32; the float32
layer scale ``gamma`` promotes each block's output, and so the residual
stream after the first block, to float32, as it does in the JAX package.
Like the JAX backbone, it takes no padding mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import dense, depthwise_conv, gelu_exact


class AdaLayerNorm(nn.Module):
    """LayerNorm (eps 1e-6) with time-conditioned scale and shift; identity
    at init (scale bias 1, the rest 0)."""

    def __init__(self, dim: int, cond_dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Linear(cond_dim, dim)
        self.shift = nn.Linear(cond_dim, dim)
        nn.init.zeros_(self.scale.weight)
        nn.init.ones_(self.scale.bias)
        nn.init.zeros_(self.shift.weight)
        nn.init.zeros_(self.shift.bias)

    def forward(self, x, cond):  # cond: the float32 time embedding
        scale = self.scale(cond)[:, None, :]
        shift = self.shift(cond)[:, None, :]
        y = F.layer_norm(x.float(), x.shape[-1:], eps=self.eps)
        return (y * scale + shift).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """Depthwise conv k = 7 -> AdaLayerNorm -> pointwise MLP with exact
    GELU -> layer scale ``gamma`` -> + residual."""

    def __init__(self, dim: int, intermediate_dim: int, cond_dim: int,
                 layer_scale_init_value: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = AdaLayerNorm(dim, cond_dim)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x, cond):
        y = depthwise_conv(self.dwconv, x, self.dtype).transpose(1, 2)
        y = self.norm(y, cond)
        y = gelu_exact(dense(self.pwconv1, y, self.dtype).float())
        y = dense(self.pwconv2, y, self.dtype)
        return x + y * self.gamma


class ConvNeXtBackbone(nn.ModuleList):
    """``num_layers`` ConvNeXt blocks of inner width ``dim * mult``
    conditioned on the time embedding; the vector field applies the final
    LayerNorm after them."""

    def __init__(self, dim: int, num_layers: int = 8, mult: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__([ConvNeXtBlock(dim, dim * mult, dim, 1.0, dtype)
                          for _ in range(num_layers)])

    def forward(self, x, time_emb):
        for block in self:
            x = block(x, time_emb)
        return x
