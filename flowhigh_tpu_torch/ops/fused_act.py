"""Anti-aliased snake activation: kernel A (``csrc/snake_aa.cu``) and its
plain PyTorch version.

``snake_activation1d`` replaces the JAX package's Pallas kernels
``flowhigh_tpu/ops/fused_act.py:fused_snake_activation1d`` (C = 768, 384
stages) and ``flowhigh_tpu/ops/packed.py:packed_snake_activation1d`` (the
packed C = 192, 96, 48 stages and ``activation_post``). It computes
down2(snake(up2(x))) in one pass: the 2x-rate intermediate stays in shared
memory. Bound: device memory, 8 bytes per element (one read, one write).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_filters: dict[torch.device, torch.Tensor] = {}


def _filter(device: torch.device) -> torch.Tensor:
    """The 12-tap half-band filter kaiser_sinc_filter1d(0.25, 0.3, 12)."""
    if device not in _filters:
        from ..models.bigvgan import kaiser_sinc_filter1d
        _filters[device] = torch.from_numpy(
            kaiser_sinc_filter1d(0.25, 0.3, 12)).to(device)
    return _filters[device]


def snake_activation1d_plain(x: torch.Tensor, alpha: torch.Tensor,
                             beta: Optional[torch.Tensor],
                             logscale: bool = True) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]: upsample1d -> snake(beta) -> downsample1d."""
    from ..models.bigvgan import downsample1d, snake, snake_beta, upsample1d
    u = upsample1d(x, 2, 12)
    s = (snake_beta(u, alpha, beta, logscale) if beta is not None
         else snake(u, alpha, logscale))
    return downsample1d(s, 2, 12)


def snake_activation1d(x: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor],
                       logscale: bool = True) -> torch.Tensor:
    """[B, C, T] float32 -> [B, C, T]. ``beta=None`` is plain snake. A CPU
    tensor takes the plain version; a CUDA tensor launches kernel A."""
    if x.device.type == "cpu":
        return snake_activation1d_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"snake_activation1d: unsupported device {x.device}")
    bsz, c, t = x.shape
    for name, v in (("x", x), ("alpha", alpha)) + (
            (("beta", beta),) if beta is not None else ()):
        if v.device != x.device or v.dtype != torch.float32 \
                or not v.is_contiguous():
            raise ValueError(f"snake_activation1d: {name} must be a contiguous "
                             f"float32 tensor on {x.device}")
    if alpha.shape != (c,) or (beta is not None and beta.shape != (c,)):
        raise ValueError("snake_activation1d: alpha/beta must have shape [C]")
    if bsz * c > 65535:
        raise ValueError("snake_activation1d: B*C must be <= 65535")
    y = torch.empty_like(x)
    lib = _build.library("snake_aa")
    err = lib.snake_aa_f32(
        x.data_ptr(), alpha.data_ptr(),
        beta.data_ptr() if beta is not None else None,
        _filter(x.device).data_ptr(), y.data_ptr(), bsz * c, c, t,
        int(logscale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "snake_aa")
    snake_activation1d.launches += 1
    return y


snake_activation1d.launches = 0
