"""Anti-aliased snake activation: kernel A (``csrc/snake_aa.cu``) and its
plain PyTorch version.

``snake_activation1d`` replaces the JAX package's Pallas kernels
``flowhigh_tpu/ops/fused_act.py:fused_snake_activation1d`` (C = 768, 384
stages) and ``flowhigh_tpu/ops/packed.py:packed_snake_activation1d`` (the
packed C = 192, 96, 48 stages and ``activation_post``). It computes
down2(snake(up2(x))) in one pass: each thread's strip of outputs and its
2x-rate samples stay in registers, the halos pass between lanes by
shuffles. Bound: device memory, 8 bytes per element (one read, one
write; 4 on bfloat16 maps). Any B*C. x may be float32 or bfloat16 (the
feature maps' storage dtype, ``ops/quant.py``): y comes in x's dtype,
computed in f32 on the widened values and rounded once.

Under autograd (a CUDA tensor that requires a gradient, grad mode on) the
float32 instance runs as a ``torch.autograd.Function``: the forward
launches kernel A, the backward is the VJP of ``snake_activation1d_plain``
recomputed from the saved x, alpha and beta, as the JAX package's
``fused_snake_activation1d`` is a ``custom_vjp`` whose backward is the VJP
of its unfused composition. bfloat16 maps raise under autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils import cudnn_f32
from . import _build
from .conv import (STORE_NAME, _check_grad_instance, _check_maps,
                   count_launch, in_f32, wants_grad)

_filters: dict[torch.device, torch.Tensor] = {}


def _filter(device: torch.device) -> torch.Tensor:
    """The 12-tap half-band filter kaiser_sinc_filter1d(0.25, 0.3, 12)."""
    if device not in _filters:
        from ..models.bigvgan import kaiser_sinc_filter1d
        with torch.inference_mode(False):  # an ordinary tensor, as
            _filters[device] = torch.from_numpy(  # utils.device_constant's
                kaiser_sinc_filter1d(0.25, 0.3, 12)).to(device)
    return _filters[device]


@functools.cache
def taps_host() -> ctypes.Array:
    """The 12 taps of ``_filter`` in host memory, made once: kernel A's
    entry points read them at the launch and pass them by value."""
    from ..models.bigvgan import kaiser_sinc_filter1d
    return (ctypes.c_float * 12)(*kaiser_sinc_filter1d(0.25, 0.3, 12).tolist())


@in_f32
def snake_activation1d_plain(x: torch.Tensor, alpha: torch.Tensor,
                             beta: Optional[torch.Tensor],
                             logscale: bool = True) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]: upsample1d -> snake(beta) -> downsample1d
    (bfloat16 x: on its float32 values, rounded at the end)."""
    from ..models.bigvgan import downsample1d, snake, snake_beta, upsample1d
    u = upsample1d(x, 2, 12)
    s = (snake_beta(u, alpha, beta, logscale) if beta is not None
         else snake(u, alpha, logscale))
    return downsample1d(s, 2, 12)


def snake_activation1d_ordered(x: torch.Tensor, alpha: torch.Tensor,
                               beta: Optional[torch.Tensor],
                               logscale: bool = True) -> torch.Tensor:
    """``snake_activation1d_plain``'s function computed as the int8
    instances of kernels D and E compute their activation
    (``csrc/act_conv_core.cuh``, ``Pass::activate`` with ``ORDERED``):
    every product and sum a separate f32 operation in the kernel's order
    (the 12-tap resamplers as running sums from 0, tap by tap), the same
    ``sin`` and ``exp``, and ``1 / (b + 1e-9)`` as an IEEE division. On the
    card the two agree bit for bit, so an int8 activation and its plain
    version quantise to the same integers; the resamplers of the plain
    version (cuDNN) round differently and flipped a quantum now and then.
    [B, C, T] -> [B, C, T]."""
    bsz, c, t = x.shape
    h = _filter(x.device)
    a = alpha[None, :, None]
    b = (beta if beta is not None else alpha)[None, :, None]
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    inv_b = torch.ones_like(b) / (b + 1e-9)
    # 2x rate: s[2m] = sum_k 2 h[2k] x[m - 3 + k], s[2m + 1] = sum_k
    # 2 h[2k + 1] x[m - 2 + k], x replicate-padded
    xp = torch.nn.functional.pad(x, (3, 3), mode="replicate")
    se, so = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(6):
        se = se + (2.0 * h[2 * k]) * xp[..., k:k + t]
        so = so + (2.0 * h[2 * k + 1]) * xp[..., k + 1:k + 1 + t]

    def snake_fn(u):
        p = torch.sin(u * a)
        return u + inv_b * (p * p)

    s = torch.stack((snake_fn(se), snake_fn(so)), dim=-1).reshape(bsz, c, 2 * t)
    # down: y[n] = sum_q h[q] s[2n - 5 + q], the 2x-rate index clamped
    sp = torch.nn.functional.pad(s, (5, 5), mode="replicate")
    y = torch.zeros_like(x)
    for q in range(12):
        y = y + h[q] * sp[..., q:q + 2 * t - 1:2]
    return y


def snake_activation1d(x: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor],
                       logscale: bool = True) -> torch.Tensor:
    """[B, C, T] float32 or bfloat16 -> [B, C, T] in x's dtype.
    ``beta=None`` is plain snake. A CPU tensor takes the plain version; a
    CUDA tensor launches kernel A."""
    if x.device.type == "cpu":
        return snake_activation1d_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"snake_activation1d: unsupported device {x.device}")
    c = x.shape[1]
    store = _check_maps("snake_activation1d", x, (), (alpha, beta))
    if alpha.shape != (c,) or (beta is not None and beta.shape != (c,)):
        raise ValueError("snake_activation1d: alpha/beta must have shape [C]")
    if wants_grad(x, alpha, beta):
        _check_grad_instance("snake_activation1d", torch.float32, store)
        return _SnakeGrad.apply(x, alpha, beta, logscale)
    return _launch_snake(x, alpha, beta, logscale, store)


def _launch_snake(x, alpha, beta, logscale, store) -> torch.Tensor:
    """One launch of kernel A on checked arguments."""
    bsz, c, t = x.shape
    y = torch.empty_like(x)
    lib = _build.library("snake_aa")
    err = getattr(lib, f"snake_aa_f32{STORE_NAME[store]}")(
        x.data_ptr(), alpha.data_ptr(),
        beta.data_ptr() if beta is not None else None, taps_host(),
        y.data_ptr(), bsz * c, c, t, int(logscale),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "snake_aa")
    count_launch(snake_activation1d, torch.float32, store)
    return y


class _SnakeGrad(torch.autograd.Function):
    """Kernel A on float32 maps under autograd: the forward launches the
    kernel; the backward recomputes ``snake_activation1d_plain`` from the
    saved inputs and returns its VJP (dx, dalpha, dbeta; None for a missing
    beta), as the JAX package's ``_bwd`` does."""

    @staticmethod
    def forward(ctx, x, alpha, beta, logscale):
        ctx.save_for_backward(x, alpha, beta)
        ctx.logscale = logscale
        return _launch_snake(x, alpha, beta, logscale, torch.float32)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad(), cudnn_f32():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            y = snake_activation1d_plain(*leaves, ctx.logscale)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(leaves, need) if n], g))
        return tuple(next(grads) if n else None for n in need) + (None,)


snake_activation1d.launches = 0
snake_activation1d.storage_launches = {torch.float32: 0}
