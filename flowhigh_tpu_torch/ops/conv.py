"""BigVGAN's convolutions: kernel B (``csrc/conv1d_same.cu``), kernel C
(``csrc/conv_transpose1d.cu``) and their plain PyTorch versions.

- ``conv1d`` replaces ``flowhigh_tpu/ops/packed.py:pallas_packed_conv1d``:
  a dilated "same" conv with zero padding and the epilogue
  ``out_scale * (conv + bias + sum(residuals))`` (up to three residuals);
  the kernel has instances for K in {3, 7, 11}, and any odd K when
  Cout < 16.
- ``conv_transpose1d`` replaces
  ``flowhigh_tpu/ops/packed.py:pallas_packed_conv_transpose1d``: a
  ConvTranspose1d with stride u, padding (K - u) / 2 and exactly u*T
  outputs, + bias, computed as a polyphase conv.

Both are bound by f32 arithmetic on the card (see the sources). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

``dot_dtype`` (``ops/quant.py``) picks the kernel's instance: float32 (the
default), bfloat16 (B and C) or int8 (B, over the windows of
``quant.conv1d_int8``; Cout >= 16). Inputs and outputs stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import cudnn_f32
from . import _build
from .quant import (bf16_weights, check_dot_dtype, conv1d_int8, int8_weights,
                    round_bf16)

CONV_TILE = 256  # kernel B's time tile: the int8 partition of conv1d
# the name of each instance's C entry point, and its code for the
# ``*_supported`` queries
DOT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
DOT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(what: str, x: torch.Tensor, *tensors) -> None:
    for v in (x,) + tensors:
        if v is None:
            continue
        if v.device != x.device or v.dtype != torch.float32 \
                or not v.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous float32 "
                             f"tensors on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def weight_ptrs(w: torch.Tensor, dot_dtype: torch.dtype) -> tuple:
    """The data pointers a kernel instance takes for one weight tensor:
    (w,) float32, (round_bf16(w),) bfloat16, (wq int32, s_w) int8."""
    if dot_dtype == torch.int8:
        return tuple(v.data_ptr() for v in int8_weights(w))
    if dot_dtype == torch.bfloat16:
        return (bf16_weights(w).data_ptr(),)
    return (w.data_ptr(),)


def count_launch(fn, dot_dtype: torch.dtype) -> None:
    """One launch of ``fn``'s instance for ``dot_dtype``: ``fn.launches``
    counts the float32 instance, ``fn.variant_launches[dtype]`` the others."""
    if dot_dtype == torch.float32:
        fn.launches += 1
    else:
        fn.variant_launches[dot_dtype] += 1


def conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 *, dilation: int = 1, residuals: Sequence[torch.Tensor] = (),
                 out_scale: float = 1.0, dot_dtype: torch.dtype = torch.float32,
                 tile: int = CONV_TILE) -> torch.Tensor:
    """x [B, Cin, T], w [Cout, Cin, K] (K odd) -> [B, Cout, T]. ``tile`` is
    the int8 partition (``ops/quant.py``)."""
    if check_dot_dtype(dot_dtype) == torch.int8:
        y = conv1d_int8(x, w, dilation=dilation, tile=tile)
        if b is not None:
            y = y + b[:, None]
    else:
        if dot_dtype == torch.bfloat16:
            x, w = round_bf16(x), bf16_weights(w)
        with cudnn_f32():
            y = F.conv1d(x, w, b, padding=dilation * (w.shape[-1] - 1) // 2,
                         dilation=dilation)
    for r in residuals:
        y = y + r
    return y if out_scale == 1.0 else y * out_scale


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
           dilation: int = 1, residuals: Sequence[torch.Tensor] = (),
           out_scale: float = 1.0,
           dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dilated "same" conv with fused bias, residuals and scale (kernel B)."""
    residuals = tuple(residuals)
    check_dot_dtype(dot_dtype)
    if x.device.type == "cpu":
        return conv1d_plain(x, w, b, dilation=dilation, residuals=residuals,
                            out_scale=out_scale, dot_dtype=dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d: unsupported device {x.device}")
    bsz, cin, t = x.shape
    cout, cin_w, k = w.shape
    if cin_w != cin or k % 2 == 0 or len(residuals) > 3:
        raise ValueError(f"conv1d: bad shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} or > 3 residuals")
    if b is not None and b.shape != (cout,):
        raise ValueError("conv1d: bias must have shape [Cout]")
    if any(r.shape != (bsz, cout, t) for r in residuals):
        raise ValueError("conv1d: residuals must have the output's shape")
    _check("conv1d", x, w, b, *residuals)
    lib = _build.library("conv1d_same")
    if not lib.conv1d_same_supported(k, cout, DOT_CODE[dot_dtype]):
        raise ValueError(f"conv1d: no kernel instance for K={k}, Cout={cout}, "
                         f"dot_dtype={dot_dtype}")
    y = torch.empty((bsz, cout, t), device=x.device, dtype=torch.float32)
    rp = [r.data_ptr() for r in residuals] + [None] * (3 - len(residuals))
    err = getattr(lib, f"conv1d_same_{DOT_NAME[dot_dtype]}")(
        x.data_ptr(), *weight_ptrs(w, dot_dtype),
        b.data_ptr() if b is not None else None, rp[0], rp[1], rp[2],
        y.data_ptr(), bsz, cin, cout, t, k, dilation, float(out_scale),
        _stream(x))
    _build.check(err, "conv1d_same")
    count_launch(conv1d, dot_dtype)
    return y


conv1d.launches = 0
conv1d.variant_launches = {torch.bfloat16: 0, torch.int8: 0}


def _check_convt_dtype(dot_dtype: torch.dtype) -> None:
    if check_dot_dtype(dot_dtype) == torch.int8:
        raise ValueError("conv_transpose1d: no int8 instance (the vocoder's "
                         "upsamplers stay float32 under int8)")


def conv_transpose1d_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor], *, stride: int,
                           dot_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """x [B, Cin, T], w [Cin, Cout, K] -> [B, Cout, (T-1)*stride - 2*pad + K]
    with pad = (K - stride) // 2 (stride*T when K - stride is even)."""
    _check_convt_dtype(dot_dtype)
    if dot_dtype == torch.bfloat16:
        x, w = round_bf16(x), bf16_weights(w)
    with cudnn_f32():
        return F.conv_transpose1d(x, w, b, stride=stride,
                                  padding=(w.shape[-1] - stride) // 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], *, stride: int,
                     dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ConvTranspose1d, padding (K - stride) // 2, + bias (kernel C, which
    has instances for BigVGAN's (stride, K) pairs and (8, 16), all with
    K - stride even and so exactly stride*T outputs)."""
    _check_convt_dtype(dot_dtype)
    if x.device.type == "cpu":
        return conv_transpose1d_plain(x, w, b, stride=stride,
                                      dot_dtype=dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_transpose1d: unsupported device {x.device}")
    bsz, cin, t = x.shape
    cin_w, cout, k = w.shape
    if cin_w != cin or (b is not None and b.shape != (cout,)):
        raise ValueError(f"conv_transpose1d: bad shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}")
    _check("conv_transpose1d", x, w, b)
    lib = _build.library("conv_transpose1d")
    if not lib.conv_transpose1d_supported(stride, k):
        raise ValueError(f"conv_transpose1d: no kernel instance for "
                         f"stride={stride}, K={k}")
    y = torch.empty((bsz, cout, stride * t), device=x.device,
                    dtype=torch.float32)
    err = getattr(lib, f"conv_transpose1d_{DOT_NAME[dot_dtype]}")(
        x.data_ptr(), *weight_ptrs(w, dot_dtype),
        b.data_ptr() if b is not None else None,
        y.data_ptr(), bsz, cin, cout, t, stride, k, _stream(x))
    _build.check(err, "conv_transpose1d")
    count_launch(conv_transpose1d, dot_dtype)
    return y


conv_transpose1d.launches = 0
conv_transpose1d.variant_launches = {torch.bfloat16: 0}
