"""BigVGAN's convolutions: kernel B (``csrc/conv1d_same.cu``), kernel C
(``csrc/conv_transpose1d.cu``) and their plain PyTorch versions.

- ``conv1d`` replaces ``flowhigh_tpu/ops/packed.py:pallas_packed_conv1d``:
  a dilated "same" conv with zero padding and the epilogue
  ``out_scale * (conv + bias + sum(residuals))`` (up to three residuals);
  the kernel has instances for K in {3, 7, 11}, and any odd K when
  Cout < 16. From Cout = 16 on, every instance runs on the tensor cores
  (bf16 and s8 ``mma.sync``, 3xTF32 for float32) and takes its weights in
  the layout ``conv_weights`` prepares once per weight tensor; below
  (``conv_post``) float32 and bfloat16 run a bytes-bound kernel on the FMA
  units. The int8 instance launches a pre-pass first, the window scales'
  kernel (``conv1d_amax_plain`` is its plain version): the largest |x| of
  each int8 window in partial maxima of 8 channels, into scratch that the
  wrapper allocates.
- ``conv_transpose1d`` replaces
  ``flowhigh_tpu/ops/packed.py:pallas_packed_conv_transpose1d``: a
  ConvTranspose1d with stride u, padding (K - u) / 2 and exactly u*T
  outputs, + bias, computed as a polyphase conv (``convt_phase_plan``) on
  the tensor cores: bf16 ``mma.sync``, and 3xTF32 for float32. It takes its
  weights in the layout ``convt_weights`` prepares once per weight tensor.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

Under autograd (a CUDA tensor that requires a gradient, grad mode on) the
float32 instances on float32 maps run as ``torch.autograd.Function``s:
the forward launches the kernel, the backward is the VJP of the plain
version (``aten.convolution_backward``, what autograd of ``F.conv1d`` /
``F.conv_transpose1d`` calls). On that route the kernels stand for the
JAX package's XLA convs (its plain generator, which its vocoder trainer
differentiates). The other instances stand for Pallas kernels only, which
JAX cannot differentiate, and raise ``ValueError`` under autograd. Without
a gradient the wrappers launch the kernels directly, as before.

``dot_dtype`` (``ops/quant.py``) picks the kernel's instance: float32 (the
default), bfloat16 (B and C) or int8 (B, over the windows of
``quant.conv1d_int8``, which are its tiles; Cout >= 16). Kernels B and C
also take bfloat16 feature maps (their ``*_bf16io`` instances): x (and B's
residuals) in bf16, y returned in bf16, each dot dtype on the widened
values. B's are the storage dtype's (``ops/quant.py``); C's come with the
vocoder's compute dtype bf16 (``BigVGAN(dtype=torch.bfloat16)``), under
which the JAX package feeds its upsamplers bf16 and stores their output in
bf16; under the storage dtype alone the vocoder feeds C float32, as the
JAX package does.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import cudnn_f32
from . import _build
from .quant import (_cached, bf16_weights, check_dot_dtype, conv1d_int8,
                    int8_weights, quantize_weights, round_bf16, window_amax)

CONV_TILE = 256  # kernel B.int8's time tile: the int8 partition of conv1d
AMAX_CH = 8  # channels a partial maximum of B.int8's pre-pass
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
# the int8 instances of kernels B, D and E take Cin in chunks of 32, one s8
# mma.sync k-step (csrc/conv1d_same.cu: CIN_ALIGN_I8; act_conv_core.cuh:
# MmaOps<Dot::I8>::KC)
INT8_CIN_ALIGN = 32
SMEM_PER_BLOCK = 232448  # bytes a block may use on the H100 (227 KB opt-in)
# the feature maps' storage dtypes: the suffix of each instance's C entry
# point (csrc: Store::F32, Store::BF16)
STORE_NAME = {torch.float32: "", torch.bfloat16: "_bf16io"}


def _check_maps(what: str, x: torch.Tensor, maps: Sequence[torch.Tensor],
                params: Sequence[Optional[torch.Tensor]]) -> torch.dtype:
    """x and the feature maps (residuals) contiguous on x's device in one
    storage dtype (float32 or bfloat16), which it returns; the parameters
    (weights, biases, snake parameters) contiguous float32 there."""
    if x.dtype not in STORE_NAME:
        raise ValueError(f"{what}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    for v in (x,) + tuple(maps):
        if v.device != x.device or v.dtype != x.dtype \
                or not v.is_contiguous():
            raise ValueError(f"{what}: x and the residuals must be contiguous "
                             f"{x.dtype} tensors on {x.device}")
    for v in params:
        if v is not None and (v.device != x.device or v.dtype != torch.float32
                              or not v.is_contiguous()):
            raise ValueError(f"{what}: weights and parameters must be "
                             f"contiguous float32 tensors on {x.device}")
    return x.dtype


def in_f32(fn):
    """A plain version that takes bfloat16 feature maps: ``fn`` on the
    maps widened to float32 (exact), its result rounded once to the input's
    dtype (nearest even), where the kernel stores. Tensors other than
    ``x`` are widened where they are bfloat16 (the residuals); the
    parameters are float32 anyway."""
    def wide(v):
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            return v.float()
        if isinstance(v, (tuple, list)):
            return type(v)(wide(u) for u in v)
        return v

    @functools.wraps(fn)
    def plain(x, *args, **kw):
        if x.dtype == torch.float32:
            return fn(x, *args, **kw)
        return fn(x.float(), *wide(args), **{k: wide(v) for k, v in
                                             kw.items()}).to(x.dtype)
    return plain


# what jax.grad raises on the JAX package's Pallas kernels, which have no VJP
PALLAS_NO_GRAD = ("Linearization failed to produce known values for all "
                  "output primals")


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd would differentiate a call on ``tensors``: grad
    mode is on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_grad_error(what: str, instance: str) -> ValueError:
    """The refusal of an instance that has no gradient."""
    return ValueError(
        f"{what}: the {instance} instance has no gradient: it stands for a "
        f"Pallas kernel of the JAX package, where jax.grad fails with "
        f"'{PALLAS_NO_GRAD}'. Train with float32 dots and float32 maps and "
        f"fuse_act_conv=False (kernels A, B and C), as the JAX package's "
        f"vocoder trainer trains its plain generator")


def _check_grad_instance(what: str, dot_dtype: torch.dtype,
                         store: torch.dtype) -> None:
    """Only the float32 instance on float32 maps has a gradient."""
    if dot_dtype != torch.float32 or store != torch.float32:
        maps = f"{str(store).removeprefix('torch.')}-map"
        raise no_grad_error(what, maps if dot_dtype == torch.float32 else
                            f"{DOT_NAME[dot_dtype]}-dot, {maps}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def weight_ptrs(w: torch.Tensor, dot_dtype: torch.dtype) -> tuple:
    """The data pointer of kernel B's narrow route for one weight tensor:
    (w,) float32, (round_bf16(w),) bfloat16."""
    if dot_dtype == torch.bfloat16:
        return (bf16_weights(w).data_ptr(),)
    return (w.data_ptr(),)


def count_launch(fn, dot_dtype: torch.dtype,
                 store: torch.dtype = torch.float32) -> None:
    """One launch of ``fn``'s instance for ``dot_dtype`` and the storage
    dtype ``store``: on float32 maps ``fn.launches`` counts the float32
    instance, ``fn.variant_launches[dtype]`` the others; on bfloat16 maps
    ``fn.storage_launches[dtype]``."""
    if store == torch.bfloat16:
        fn.storage_launches[dot_dtype] += 1
    elif dot_dtype == torch.float32:
        fn.launches += 1
    else:
        fn.variant_launches[dot_dtype] += 1


@in_f32
def conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 *, dilation: int = 1, residuals: Sequence[torch.Tensor] = (),
                 out_scale: float = 1.0, dot_dtype: torch.dtype = torch.float32,
                 tile: int = CONV_TILE) -> torch.Tensor:
    """x [B, Cin, T], w [Cout, Cin, K] (K odd) -> [B, Cout, T]. ``tile`` is
    the int8 partition (``ops/quant.py``). bfloat16 x and residuals: the
    same on their float32 values, rounded to bfloat16 at the end
    (``in_f32``)."""
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
    bfloat16; int8: ``quantize_weights(w)``'s integers, Cin padded to
    ``INT8_CIN_ALIGN`` (their scales are ``int8_weights(w)[1]``)."""
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


def conv_smem_bytes(k: int, dilation: int, cout: int,
                    dot_dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory one block of kernel B's GEMM route takes
    (``Gemm::smem`` in csrc/conv1d_same.cu). A block owns tc = 64 output
    channels, or 48 where 48 divides Cout and 64 does not, over 256 frames,
    and stages per chunk of 8 (float32), 16 (bfloat16) or 32 (int8) input
    channels, twice (double-buffered): the chunk's weights, K x tc rows of
    32 bytes, and x over rows = 256 + d (K - 1) frames as the fragments
    read it: float32 [frame][20] floats (TF32 hi and lo), bfloat16 [frame]
    [24] bf16, int8 32-byte rows of quanta. bfloat16 and int8 also keep one
    f32 staging buffer of x, [frame][20] and [frame][33] floats. Each
    buffer of x is padded to 16 bytes. The output tile, tc x 264 floats,
    reuses the same memory after the last chunk."""
    check_dot_dtype(dot_dtype)
    tc = 48 if cout % 48 == 0 and cout % 64 != 0 else 64
    rows = 256 + dilation * (k - 1)

    def pad16(n):
        return -(-n // 16) * 16

    x32 = pad16(rows * (33 if dot_dtype == torch.int8 else 20) * 4)
    stage = k * tc * 32 + (rows * 32 if dot_dtype == torch.int8
                           else pad16(rows * 48)
                           if dot_dtype == torch.bfloat16 else x32)
    extra = 0 if dot_dtype == torch.float32 else x32
    return max(2 * stage + extra, tc * 264 * 4)


def conv1d_amax_plain(x: torch.Tensor, k: int, dilation: int
                      ) -> torch.Tensor:
    """The plain version of kernel B.int8's pre-pass (the window scales'
    kernel, ``conv1d_amax_kernel`` in csrc/conv1d_same.cu): x [B, Cin, T]
    -> [B, ceil(T / 256), ceil(Cin / 8)], the largest |x| over each window
    of ``quant.conv1d_int8`` ([256 w - pad, 256 w + 256 + pad) ∩ [0, T),
    pad = d (K - 1) / 2) and each 8 channels."""
    pad = dilation * (k - 1) // 2
    return window_amax(x.float(), -pad, CONV_TILE + 2 * pad, CONV_TILE,
                       -(-x.shape[-1] // CONV_TILE), AMAX_CH)


@functools.cache
def _conv_library(store: torch.dtype = torch.float32):
    """Kernel B's library of the instances on ``store`` maps, once its
    weight layouts are checked against ``conv_weight_layout``'s."""
    lib = _build.library("conv1d_same" + STORE_NAME[store])
    if tuple(lib.conv1d_same_weight_align(i) for i in range(3)) != (
            CONV_CIN_ALIGN, CONV_COUT_ALIGN, INT8_CIN_ALIGN):
        raise RuntimeError("conv1d: the kernel's weight layout differs from "
                           "conv_weight_layout's")
    return lib


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
           dilation: int = 1, residuals: Sequence[torch.Tensor] = (),
           out_scale: float = 1.0,
           dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dilated "same" conv with fused bias, residuals and scale (kernel B).
    x and the residuals float32 or bfloat16 (the feature maps' storage
    dtype); y comes in x's dtype."""
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
    store = _check_maps("conv1d", x, residuals, (w, b))
    if wants_grad(x, w, b, *residuals):
        _check_grad_instance("conv1d", dot_dtype, store)
        return _Conv1dGrad.apply(x, w, b, dilation, float(out_scale),
                                 *residuals)
    return _launch_conv1d(x, w, b, dilation, residuals, out_scale, dot_dtype,
                          store)


def _launch_conv1d(x, w, b, dilation, residuals, out_scale, dot_dtype,
                   store) -> torch.Tensor:
    """One launch of kernel B on checked arguments."""
    bsz, cin, t = x.shape
    cout, _, k = w.shape
    lib = _conv_library(store)
    if not lib.conv1d_same_supported(k, cout, dilation, DOT_CODE[dot_dtype]):
        raise ValueError(f"conv1d: no kernel instance for K={k}, Cout={cout}, "
                         f"dilation={dilation}, dot_dtype={dot_dtype}")
    if cout < NARROW_COUT:
        wp = weight_ptrs(w, dot_dtype)
    else:  # the GEMM route's layout
        wp = (conv_weights(w, dot_dtype).data_ptr(),)
    if dot_dtype == torch.int8:  # the weight scales, the pre-pass's scratch
        part = torch.empty((bsz, -(-t // CONV_TILE), -(-cin // AMAX_CH)),
                           device=x.device, dtype=torch.float32)
        wp += (int8_weights(w)[1].data_ptr(), part.data_ptr())
    y = torch.empty((bsz, cout, t), device=x.device, dtype=store)
    rp = [r.data_ptr() for r in residuals] + [None] * (3 - len(residuals))
    entry = f"conv1d_same_{DOT_NAME[dot_dtype]}{STORE_NAME[store]}"
    err = getattr(lib, entry)(
        x.data_ptr(), *wp,
        b.data_ptr() if b is not None else None, rp[0], rp[1], rp[2],
        y.data_ptr(), bsz, cin, cout, t, k, dilation, float(out_scale),
        _stream(x))
    _build.check(err, "conv1d_same")
    count_launch(conv1d, dot_dtype, store)
    return y


def _conv_grads(ctx, g: torch.Tensor, stride: int, padding: int,
                dilation: int, transposed: bool) -> tuple:
    """(dx, dw, db) of a conv's output gradient ``g``, each None where
    ``ctx.needs_input_grad`` (x, w, b first) says it is not wanted: the
    call autograd of ``F.conv1d`` / ``F.conv_transpose1d`` makes."""
    x, w = ctx.saved_tensors
    need = ctx.needs_input_grad
    bias = ctx.has_bias and need[2]
    with cudnn_f32():
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, x, w, [g.shape[1]] if ctx.has_bias else None, [stride],
            [padding], [dilation], transposed, [0], 1,
            [need[0], need[1], bias])
    return dx, dw, db if bias else None


class _Conv1dGrad(torch.autograd.Function):
    """Kernel B's float32 instance under autograd: the forward launches the
    kernel, the backward is the VJP of ``conv1d_plain`` (the conv's VJP of
    ``out_scale * g``, which is also each residual's gradient)."""

    @staticmethod
    def forward(ctx, x, w, b, dilation, out_scale, *residuals):
        ctx.save_for_backward(x, w)
        ctx.has_bias, ctx.dilation, ctx.out_scale = (b is not None, dilation,
                                                     out_scale)
        return _launch_conv1d(x, w, b, dilation, residuals, out_scale,
                              torch.float32, torch.float32)

    @staticmethod
    def backward(ctx, g):
        gs = g if ctx.out_scale == 1.0 else g * ctx.out_scale
        k = ctx.saved_tensors[1].shape[-1]
        grads = _conv_grads(ctx, gs, 1, ctx.dilation * (k - 1) // 2,
                            ctx.dilation, False)
        return grads + (None, None) + tuple(
            gs if need else None for need in ctx.needs_input_grad[5:])


conv1d.launches = 0
conv1d.variant_launches = {torch.bfloat16: 0, torch.int8: 0}
conv1d.storage_launches = {torch.float32: 0, torch.bfloat16: 0, torch.int8: 0}


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


@in_f32
def conv_transpose1d_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor], *, stride: int,
                           dot_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """x [B, Cin, T], w [Cin, Cout, K] -> [B, Cout, (T-1)*stride - 2*pad + K]
    with pad = (K - stride) // 2 (stride*T when K - stride is even).
    bfloat16 x: the same on its float32 values, bias added in float32,
    rounded to bfloat16 once at the end (``in_f32``)."""
    _check_convt_dtype(dot_dtype)
    if dot_dtype == torch.bfloat16:
        x, w = round_bf16(x), bf16_weights(w)
    with cudnn_f32():
        return F.conv_transpose1d(x, w, b, stride=stride,
                                  padding=(w.shape[-1] - stride) // 2)


@functools.cache
def _convt_library(store: torch.dtype = torch.float32):
    """Kernel C's library of the instances on ``store`` maps, once its
    weight layout is checked against ``convt_weight_layout``'s."""
    lib = _build.library("conv_transpose1d" + STORE_NAME[store])
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
    K - stride even and so exactly stride*T outputs). x float32 or
    bfloat16 (the feature maps); y comes in x's dtype."""
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
    store = _check_maps("conv_transpose1d", x, (), (w, b))
    if wants_grad(x, w, b):
        _check_grad_instance("conv_transpose1d", dot_dtype, store)
        return _ConvT1dGrad.apply(x, w, b, stride)
    return _launch_conv_transpose1d(x, w, b, stride, dot_dtype, store)


def _launch_conv_transpose1d(x, w, b, stride, dot_dtype,
                             store=torch.float32) -> torch.Tensor:
    """One launch of kernel C on checked arguments."""
    bsz, cin, t = x.shape
    _, cout, k = w.shape
    lib = _convt_library(store)
    if not lib.conv_transpose1d_supported(stride, k):
        raise ValueError(f"conv_transpose1d: no kernel instance for "
                         f"stride={stride}, K={k}")
    y = torch.empty((bsz, cout, stride * t), device=x.device, dtype=store)
    entry = f"conv_transpose1d_{DOT_NAME[dot_dtype]}{STORE_NAME[store]}"
    err = getattr(lib, entry)(
        x.data_ptr(), convt_weights(w, dot_dtype).data_ptr(),
        b.data_ptr() if b is not None else None,
        y.data_ptr(), bsz, cin, cout, t, stride, k, _stream(x))
    _build.check(err, "conv_transpose1d")
    count_launch(conv_transpose1d, dot_dtype, store)
    return y


class _ConvT1dGrad(torch.autograd.Function):
    """Kernel C's float32 instance under autograd: the forward launches the
    kernel, the backward is the VJP of ``conv_transpose1d_plain``."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.has_bias, ctx.stride = b is not None, stride
        return _launch_conv_transpose1d(x, w, b, stride, torch.float32)

    @staticmethod
    def backward(ctx, g):
        k = ctx.saved_tensors[1].shape[-1]
        return _conv_grads(ctx, g, ctx.stride, (k - ctx.stride) // 2, 1,
                           True) + (None,)


conv_transpose1d.launches = 0
conv_transpose1d.variant_launches = {torch.bfloat16: 0}
conv_transpose1d.storage_launches = {torch.float32: 0, torch.bfloat16: 0}
