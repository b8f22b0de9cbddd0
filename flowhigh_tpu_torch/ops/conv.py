"""BigVGAN's convolutions: kernel B (``csrc/conv1d_same.cu``), kernel C
(``csrc/conv_transpose1d.cu``) and their plain PyTorch versions.

- ``conv1d`` replaces ``flowhigh_tpu/ops/packed.py:pallas_packed_conv1d``:
  a dilated "same" conv with zero padding and the epilogue
  ``out_scale * (conv + bias + sum(residuals))`` (up to three residuals);
  the kernel has instances for K in {3, 7, 11}, and any odd K when
  Cout < 16. From Cout = 16 on, its float32 and bfloat16 instances run on
  the tensor cores (bf16 ``mma.sync``, 3xTF32 for float32) and take their
  weights in the layout ``conv_weights`` prepares once per weight tensor;
  below (``conv_post``) they run a bytes-bound kernel on the FMA units.
- ``conv_transpose1d`` replaces
  ``flowhigh_tpu/ops/packed.py:pallas_packed_conv_transpose1d``: a
  ConvTranspose1d with stride u, padding (K - u) / 2 and exactly u*T
  outputs, + bias, computed as a polyphase conv (``convt_phase_plan``) on
  the tensor cores: bf16 ``mma.sync``, and 3xTF32 for float32. It takes its
  weights in the layout ``convt_weights`` prepares once per weight tensor.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

``dot_dtype`` (``ops/quant.py``) picks the kernel's instance: float32 (the
default), bfloat16 (B and C) or int8 (B, over the windows of
``quant.conv1d_int8``; Cout >= 16). Inputs and outputs stay float32.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import cudnn_f32
from . import _build
from .quant import (_cached, bf16_weights, check_dot_dtype, conv1d_int8,
                    int8_weights, quantize_weights, round_bf16)

CONV_TILE = 256  # kernel B.int8's time tile: the int8 partition of conv1d
NARROW_COUT = 16  # below it, kernel B's narrow route (conv_post)
# the name of each instance's C entry point, and its code for the
# ``*_supported`` queries
DOT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
DOT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# kernel C's weight layout pads Cin and Cout to these multiples
# (csrc/conv_transpose1d.cu: CIN_ALIGN, TILE_CO; conv_transpose1d_weight_align)
CONVT_CIN_ALIGN, CONVT_COUT_ALIGN = 16, 64
# and kernel B's GEMM route's (csrc/conv1d_same.cu: CIN_ALIGN, COUT_ALIGN;
# conv1d_same_weight_align)
CONV_CIN_ALIGN, CONV_COUT_ALIGN = 16, 64
# the int8 instances of kernels D and E take Cin in chunks of 32, one s8
# mma.sync k-step (csrc/act_conv_core.cuh: MmaOps<Dot::I8>::KC)
INT8_CIN_ALIGN = 32


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


def _tap_major(w: torch.Tensor, cin_align: int, cout_align: int,
               dot_dtype: torch.dtype) -> torch.Tensor:
    """w as [K, Cout, Cin] -> [K, Cout_p, Cin_p], zero-padded to the
    multiples, contiguous: float32, bfloat16 rounded to nearest even
    (``round_bf16``'s values) for the bf16 instances, or int8 (w holding
    integers in [-127, 127])."""
    k, cout, cin = w.shape
    cin_p = -(-cin // cin_align) * cin_align
    cout_p = -(-cout // cout_align) * cout_align
    dt = dot_dtype if dot_dtype in (torch.bfloat16, torch.int8) \
        else torch.float32
    out = torch.zeros((k, cout_p, cin_p), dtype=dt, device=w.device)
    out[:, :cout, :cin] = w.to(dt)
    return out


def conv_weight_layout(w: torch.Tensor,
                       dot_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Kernel B's GEMM route and kernels D and E: w [Cout, Cin, K] -> [K,
    Cout_p, Cin_p] (``CONV_COUT_ALIGN``, ``CONV_CIN_ALIGN``), float32 or
    bfloat16; int8 (D and E only): ``quantize_weights(w)``'s integers, Cin
    padded to ``INT8_CIN_ALIGN`` (their scales are ``int8_weights(w)[1]``)."""
    if dot_dtype == torch.int8:
        return _tap_major(quantize_weights(w)[0].permute(2, 0, 1),
                          INT8_CIN_ALIGN, CONV_COUT_ALIGN, dot_dtype)
    return _tap_major(w.permute(2, 0, 1), CONV_CIN_ALIGN, CONV_COUT_ALIGN,
                      dot_dtype)


def conv_weights(w: torch.Tensor, dot_dtype: torch.dtype) -> torch.Tensor:
    """``conv_weight_layout(w, dot_dtype)``, once per weight tensor (cached
    by its version counter, as ``quant.bf16_weights``)."""
    return _cached(w, f"conv_{DOT_NAME[dot_dtype]}",
                   lambda v: conv_weight_layout(v, dot_dtype))


@functools.cache
def _conv_library():
    """Kernel B's library, once its weight layout is checked against
    ``conv_weight_layout``'s."""
    lib = _build.library("conv1d_same")
    if (lib.conv1d_same_weight_align(0),
            lib.conv1d_same_weight_align(1)) != (CONV_CIN_ALIGN,
                                                 CONV_COUT_ALIGN):
        raise RuntimeError("conv1d: the kernel's weight layout differs from "
                           "conv_weight_layout's")
    return lib


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
    lib = _conv_library()
    if not lib.conv1d_same_supported(k, cout, dilation, DOT_CODE[dot_dtype]):
        raise ValueError(f"conv1d: no kernel instance for K={k}, Cout={cout}, "
                         f"dilation={dilation}, dot_dtype={dot_dtype}")
    if dot_dtype == torch.int8 or cout < NARROW_COUT:
        wp = weight_ptrs(w, dot_dtype)
    else:  # the GEMM route's layout
        wp = (conv_weights(w, dot_dtype).data_ptr(),)
    y = torch.empty((bsz, cout, t), device=x.device, dtype=torch.float32)
    rp = [r.data_ptr() for r in residuals] + [None] * (3 - len(residuals))
    err = getattr(lib, f"conv1d_same_{DOT_NAME[dot_dtype]}")(
        x.data_ptr(), *wp,
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


def convt_phase_plan(stride: int, k: int) -> tuple:
    """Kernel C's polyphase plan: ((j, r, q), ...) for each tap j of a
    ConvTranspose1d with padding p = (k - stride) // 2, which feeds output
    phase r = (j - p) mod stride from x[m + q], q = (r + p - j) / stride:
    y[:, :, stride*m + r] += w[:, :, j]^T x[:, :, m + q]."""
    p = (k - stride) // 2
    plan = []
    for j in range(k):
        r = (j - p) % stride
        plan.append((j, r, (r + p - j) // stride))
    return tuple(plan)


def convt_weight_layout(w: torch.Tensor,
                        dot_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """w [Cin, Cout, K] -> [K, Cout_p, Cin_p], zero-padded to the multiples
    ``CONVT_COUT_ALIGN`` and ``CONVT_CIN_ALIGN``, contiguous: float32, or
    bfloat16 rounded to nearest even (``round_bf16``'s values) for the
    bf16 instance."""
    return _tap_major(w.permute(2, 1, 0), CONVT_CIN_ALIGN, CONVT_COUT_ALIGN,
                      dot_dtype)


def convt_weights(w: torch.Tensor, dot_dtype: torch.dtype) -> torch.Tensor:
    """``convt_weight_layout(w, dot_dtype)``, once per weight tensor (cached
    by its version counter, as ``quant.bf16_weights``)."""
    return _cached(w, f"convt_{DOT_NAME[dot_dtype]}",
                   lambda v: convt_weight_layout(v, dot_dtype))


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


@functools.cache
def _convt_library():
    """Kernel C's library, once its weight layout is checked against
    ``convt_weight_layout``'s."""
    lib = _build.library("conv_transpose1d")
    if (lib.conv_transpose1d_weight_align(0),
            lib.conv_transpose1d_weight_align(1)) != (CONVT_CIN_ALIGN,
                                                      CONVT_COUT_ALIGN):
        raise RuntimeError("conv_transpose1d: the kernel's weight layout "
                           "differs from convt_weight_layout's")
    return lib


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
    lib = _convt_library()
    if not lib.conv_transpose1d_supported(stride, k):
        raise ValueError(f"conv_transpose1d: no kernel instance for "
                         f"stride={stride}, K={k}")
    y = torch.empty((bsz, cout, stride * t), device=x.device,
                    dtype=torch.float32)
    err = getattr(lib, f"conv_transpose1d_{DOT_NAME[dot_dtype]}")(
        x.data_ptr(), convt_weights(w, dot_dtype).data_ptr(),
        b.data_ptr() if b is not None else None,
        y.data_ptr(), bsz, cin, cout, t, stride, k, _stream(x))
    _build.check(err, "conv_transpose1d")
    count_launch(conv_transpose1d, dot_dtype)
    return y


conv_transpose1d.launches = 0
conv_transpose1d.variant_launches = {torch.bfloat16: 0}
