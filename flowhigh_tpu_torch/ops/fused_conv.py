"""The vocoder's fused kernels: kernel D (``csrc/act_conv1d.cu``, one
act->conv pair) and kernel E (``csrc/amp_unit.cu``, one whole AMPBlock1
dilation unit), their plain PyTorch versions and the card's fusion plans.

- ``act_conv1d`` replaces ``flowhigh_tpu/ops/packed.py:
  pallas_packed_act_conv1d``: ``out_scale * (conv(act(x)) + bias +
  sum(residuals))``, the anti-aliased snake (kernel A's function) computed
  in shared memory over the conv's input window and never written to device
  memory. Two edge rules meet here: the snake replicate-pads x at the
  sequence edges, the conv zero-pads the snake's output.
- ``amp_unit`` replaces ``flowhigh_tpu/ops/packed.py:pallas_packed_amp_unit``:
  ``out_scale * (conv2(act2(conv1(act1(x)))) + x + sum(extras))`` with
  conv1 (K, d) and conv2 (K, 1). act2 replicate-pads conv1's output at the
  sequence edges (conv1's values outside [0, T) are never used).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (no fallback: a shape no kernel instance takes is an error). Both
kernels stand for Pallas kernels of the JAX package, which jax.grad cannot
differentiate, so on a CUDA tensor that autograd would differentiate they
raise ``ValueError`` (``conv.no_grad_error``); the CPU's plain versions stay
differentiable, as the JAX package's XLA paths are.

``dot_dtype`` (``ops/quant.py``) picks the instance: float32 (the default),
bfloat16 or int8. Rounding or quantisation applies to each activation
after its edge mask, as in the JAX kernels (``packed.py:829``, ``:1188``,
``:1199``); conv1's output inside a unit stays f32. Every instance runs its
convolutions on the tensor cores (3xTF32, bf16 and s8 ``mma.sync``) and
takes prepared weights (``conv.conv_weights``: kernel B's layout; int8
quantised, with ``quant.int8_weights``' scales). The int8 instances launch
a pre-pass first, the window scales' kernel (``act_amax_plain`` is its
plain version): the largest |activation| of each int8 window, in partial
maxima of 8 channels, into scratch that the wrapper allocates.

Both kernels also take bfloat16 feature maps (the storage dtype,
``ops/quant.py``): x and the residuals in bf16, y returned in bf16, every
dot dtype computed on the values widened to f32 and the output rounded
once (the ``*_bf16io`` instances; E's conv1 output stays f32 on chip). The
kernels stage the widened values in the f32 layout, so the shared memory,
and with it the plans below, do not depend on the storage dtype.

The plans decide, from shapes alone, where the vocoder routes a unit or a
pair (``models/bigvgan.py:AMPBlock1``). They are capacity rules for one
thread block's shared memory on the H100 (227 KB), mirrored from the
kernels' layouts (``*_smem_bytes`` below, checked against the built
library on the card by tests/test_torch_kernels.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build
from .conv import (DOT_NAME, SMEM_PER_BLOCK, STORE_NAME, _check_maps,
                   _stream, conv1d_plain, conv_weights, count_launch, in_f32,
                   no_grad_error, wants_grad)
from .fused_act import (_filter, snake_activation1d_ordered,
                        snake_activation1d_plain)
from .quant import (DOT_DTYPES, check_dot_dtype, int8_conv_windows,
                    int8_weights, untile, window_amax, windows)

TAPS = (3, 7, 11)        # kernel instances (BigVGAN's resblock kernels)
# the tensor-core pass (act_conv_core.cuh: act_conv_mma)
MMA_RING = 3             # weight stages, one tap of [BM][32 bytes] each
MMA_SUB = 8              # channels a snake sub-pass
# the int8 windows of ops/quant.py (act_conv_core.cuh: I8_WINDOW): kernel
# D's outputs per window (its tiles tile them), kernel E.int8's pass
INT8_TILE = 256
AMAX_CH = 8              # channels a partial maximum of the pre-pass
MAX_CLUSTER = 8          # blocks a cluster of kernel E.int8 (amp_unit.cu)


def _is_int8(dot_dtype: torch.dtype) -> bool:
    return check_dot_dtype(dot_dtype) == torch.int8


def _pair_tile(c: int, dot_dtype: torch.dtype = torch.float32
               ) -> tuple[int, int]:
    """(output channels BM, samples BN) a block of kernel D, every dtype
    (8 warps, two blocks an SM): 256 x 64 where 256 divides C (C = 768),
    128 x 128 where 128 does (C = 384), for bfloat16 and int8 in clusters
    of the C / BM blocks of a time tile, which share the activation; else
    64 x 128. BN divides ``INT8_TILE``, so int8 tiles tile its windows."""
    check_dot_dtype(dot_dtype)
    return (256, 64) if c % 256 == 0 else (128, 128) if c % 128 == 0 \
        else (64, 128)


def _cluster(c: int, dot_dtype: torch.dtype) -> bool:
    """Kernel D's bfloat16 and int8 instances at C = 768, 384 run their
    tiles in clusters that share the activation (two buffers)."""
    return dot_dtype != torch.float32 and c % 128 == 0


def _unit_tile(c: int, dot_dtype: torch.dtype = torch.float32
               ) -> tuple[int, int]:
    """(output channels per pass BM, samples per pass BN) of kernel E.
    float32 and bfloat16 (8 warps): (192, 192) where 192 divides C; BM = 96
    where 96 divides C, 48 where 48 does, over BN = 128 for bfloat16 (two
    blocks an SM) and 256 for float32; else (64, 192). int8: BN = 256, the
    window, and BM = 96 (48 where C <= 48) output channels a block of a
    cluster of ceil(C / BM) blocks (two at C = 192)."""
    if _is_int8(dot_dtype):
        return (48 if c <= 48 else 96), INT8_TILE
    if c % 192 == 0:
        return 192, 192
    bn = 128 if dot_dtype == torch.bfloat16 else 256
    return (96, bn) if c % 96 == 0 else (48, bn) if c % 48 == 0 \
        else (64, 192)


def mma_core_smem_bytes(pad: int, bn: int, bm: int, bf16: bool,
                        cluster: bool = False, int8: bool = False) -> int:
    """Bytes of shared memory that one tensor-core act->conv pass over
    ``bn`` output samples takes (the layout of ``act_conv_mma`` in the
    sources), with aw = bn + 2 pad frames and chunks of kc = 8 (float32),
    16 (``bf16``) or 32 (``int8``) input channels: a ring of 3 weight
    stages (bm rows of 32 bytes: one tap of a chunk); the activation as
    [frame][ci] rows (80 bytes: TF32 hi and lo of 8 channels at a stride of
    20 floats; 48 bytes: 16 bf16 channels at a stride of 24; 32 bytes: 32
    int8 quanta); two stages of raw input (kc x (aw + 12) floats); the
    2x-rate snake signal of an 8-channel sub-pass (8 x 2 (aw + 6)); two
    stages of snake parameters (2 x kc); the 12 filter taps are in
    constant memory. A ``cluster`` pass (kernel D's, whose blocks share the
    activation) keeps two activation buffers."""
    aw = bn + 2 * pad
    kc, row = (32, 32) if int8 else (16, 48) if bf16 else (8, 80)
    return (MMA_RING * bm * 32 + (2 if cluster else 1) * aw * row
            + 4 * (2 * kc * (aw + 12) + MMA_SUB * 2 * (aw + 6) + 2 * 2 * kc))


def unit_s8_smem_bytes(c: int, pad: int, bm: int) -> int:
    """Bytes of shared memory of one block of kernel E.int8 (the layout of
    ``amp_unit_s8_kernel``, ``s8_unit_bytes`` in the sources), with aw =
    256 + 2 pad1 frames: its conv1 output (bm x 256 floats), the whole
    quantised activation (ceil(C / 32) chunks of aw rows of 32 bytes), a
    ring of 3 weight stages (bm rows of 32 bytes), two stages of raw input
    of an 8-channel sub-pass (8 x (aw + 12) floats), its snake signal (8 x
    2 (aw + 6)), two stages of snake parameters (2 x 8) and the cluster's
    act2 maxima (8 floats)."""
    aw = INT8_TILE + 2 * pad
    return (4 * bm * INT8_TILE + -(-c // 32) * aw * 32 + MMA_RING * bm * 32
            + 4 * (2 * MMA_SUB * (aw + 12) + MMA_SUB * 2 * (aw + 6)
                   + 2 * 2 * MMA_SUB + MAX_CLUSTER))


def act_conv_smem_bytes(k: int, dilation: int, c: int,
                        dot_dtype: torch.dtype = torch.float32) -> int:
    pad = dilation * (k - 1) // 2
    bm, bn = _pair_tile(c, dot_dtype)
    return mma_core_smem_bytes(pad, bn, bm, dot_dtype == torch.bfloat16,
                               cluster=_cluster(c, dot_dtype),
                               int8=_is_int8(dot_dtype))


def amp_unit_smem_bytes(k: int, dilation: int, c: int,
                        dot_dtype: torch.dtype = torch.float32) -> int:
    """float32, bfloat16: conv1's output for all C channels over the pass
    (C x BN floats), plus the working set of the wider of the two act->conv
    passes (conv1's). int8: one block of the cluster
    (``unit_s8_smem_bytes``)."""
    bm, bn = _unit_tile(c, dot_dtype)
    pad = dilation * (k - 1) // 2
    if _is_int8(dot_dtype):
        return unit_s8_smem_bytes(c, pad, bm)
    return 4 * c * bn + mma_core_smem_bytes(pad, bn, bm,
                                            dot_dtype == torch.bfloat16)


def unit_halo(k: int) -> int:
    """Samples of conv1 output a unit tile needs beyond its outputs on each
    side: conv2's reach (k - 1) / 2 plus act2's reach of 6 (its 12-tap
    resamplers at the 2x rate)."""
    return (k - 1) // 2 + 6


def act_conv_plan(k: int, dilation: int, c: int, t: int,
                  dot_dtype: torch.dtype = torch.float32) -> int:
    """Time tile of kernel D's ``dot_dtype`` instance for this pair, 0 = not
    fusable. A pair is fusable where every instance (float32, bfloat16,
    int8) fits one block's shared memory, so that the vocoder routes it the
    same way at every dtype.

    Every instance runs on the tensor cores: a block owns BM x BN
    (``_pair_tile``: 256 x 64 at C = 768, 128 x 128 at C = 384, else
    64 x 128) and walks Cin in chunks of 8 (float32), 16 (bfloat16) or 32
    (int8) channels, one 32-byte weight row. Per chunk it stages x over the conv
    window plus the snake's reach, BN + 2 pad + 12 samples (pad = d (k -
    1) / 2), twice (double-buffered); the snake signal of 8 channels over
    BN + 2 pad + 6 positions; the activation as [frame][ci] rows over BN +
    2 pad frames; and a ring of 3 taps' weights, BM x 32 bytes each
    (``mma_core_smem_bytes``; bfloat16 and int8 at C = 768 and 384 keep
    two activation buffers, which the blocks of a cluster fill together).
    At k = 11, d = 5, C = 768, bfloat16: 24,576 + 2 x 5,472 + 16,128 +
    7,680 + 256 = 59,584 bytes, int8: 24,576 + 2 x 3,648 + 32,256 + 7,680
    + 512 = 72,320, so two blocks share an SM. Only the dilation bounds
    them: the window outgrows 227 KB near d = 500 at k = 3. The tile does
    not depend on T; the activation of a chunk is recomputed by each of the
    C / BM output-channel blocks (float32: 3x at C = 768 and 384; bfloat16,
    int8: once, shared by the cluster; int8 adds the pre-pass's snake)."""
    del t  # every T tiles into blocks
    if k not in TAPS or any(act_conv_smem_bytes(k, dilation, c, dt)
                            > SMEM_PER_BLOCK for dt in DOT_DTYPES):
        return 0
    return _pair_tile(c, dot_dtype)[1]


def amp_unit_plan(k: int, dilation: int, c: int, t: int,
                  dot_dtype: torch.dtype = torch.float32) -> int:
    """Time tile (outputs per block) of kernel E's ``dot_dtype`` instance
    for this unit, 0 = not fusable. A unit is fusable where every instance
    (float32, bfloat16, int8) fits one block's shared memory.

    conv2 mixes every channel, so a block that owns a tile of outputs needs
    conv1's output for ALL C channels over the tile plus a halo of
    H = (k - 1) / 2 + 6 samples each side, resident in shared memory while
    act2 and conv2 run from it. The block computes conv1 over a pass of BN
    samples (``_unit_tile``), so the tile is the pass less both halos.
    Capacity: C x BN x 4 bytes of conv1 output plus conv1's act->conv
    working set must fit 227 KB.

    - float32 and bfloat16 at C = 192: BN = 192 (147,456 bytes of conv1
      output) and one 192-channel pass, so each activation runs once per
      sample; the largest working set (bfloat16, k = 11, d = 5) is 78,688
      bytes, 226,144 in all. BN = 256 (196,608 bytes) would leave 35,840,
      less than one tensor-core working set. Tiles of 178 / 174 / 170
      outputs at k = 3 / 7 / 11: both convs do BN / tile = 1.08-1.13x the
      pair's work. C = 96 and 48: BN = 256 for float32 (tiles 242 / 238
      / 234, 1.06-1.09x), 128 for bfloat16 (114 / 110 / 106, 1.12-1.21x),
      so that two blocks share an SM;
    - int8: BN = 256, the window, in clusters of 96-channel blocks (two at
      C = 192), each holding its half of conv1's output and the whole
      quantised activation (``unit_s8_smem_bytes``: 206,752 bytes at
      C = 192, k = 11, d = 5);
    - C = 384 needs 295 KB of conv1 output alone at BN = 192, C = 768
      590 KB: those units are not fused and their two pairs go to kernel
      D. (A narrower pass would fit C = 384 at 128 samples, but with 4
      samples per thread and 1.21x halo work the FMA kernel ran 2.9-5x
      slower than the A + B chain of the same unit: PERF.md.)"""
    del t  # every T tiles into blocks of BN - 2 halo outputs
    if k not in TAPS or any(amp_unit_smem_bytes(k, dilation, c, dt)
                            > SMEM_PER_BLOCK for dt in DOT_DTYPES):
        return 0
    return _unit_tile(c, dot_dtype)[1] - 2 * unit_halo(k)


# --- plain versions ------------------------------------------------------------

@in_f32
def act_conv1d_plain(x: torch.Tensor, alpha: torch.Tensor,
                     beta: Optional[torch.Tensor], logscale: bool,
                     w: torch.Tensor, b: Optional[torch.Tensor], *,
                     dilation: int, residuals: Sequence[torch.Tensor] = (),
                     out_scale: float = 1.0,
                     dot_dtype: torch.dtype = torch.float32,
                     tile: int = INT8_TILE) -> torch.Tensor:
    """x [B, Cin, T], w [Cout, Cin, K] -> [B, Cout, T]:
    conv1d_plain(snake_activation1d_plain(x)) with the epilogue; ``tile``
    is the int8 partition (``ops/quant.py``). int8 takes the activation in
    the kernel's order (``snake_activation1d_ordered``). bfloat16 x and
    residuals: on their float32 values, rounded at the end (``in_f32``)."""
    act = (snake_activation1d_ordered if check_dot_dtype(dot_dtype)
           == torch.int8 else snake_activation1d_plain)
    return conv1d_plain(act(x, alpha, beta, logscale),
                        w, b, dilation=dilation, residuals=residuals,
                        out_scale=out_scale, dot_dtype=dot_dtype, tile=tile)


@in_f32
def amp_unit_plain(x: torch.Tensor, a1: torch.Tensor,
                   b1: Optional[torch.Tensor], a2: torch.Tensor,
                   b2: Optional[torch.Tensor], logscale: bool,
                   w1: torch.Tensor, bias1: Optional[torch.Tensor],
                   w2: torch.Tensor, bias2: Optional[torch.Tensor], *,
                   dilation: int, extra_residuals: Sequence[torch.Tensor] = (),
                   out_scale: float = 1.0,
                   dot_dtype: torch.dtype = torch.float32,
                   tile: Optional[int] = None) -> torch.Tensor:
    """x [B, C, T] -> out_scale * (conv2(act2(conv1(act1(x)))) + x +
    sum(extras)); conv1 is (K, dilation), conv2 (K, 1). ``tile`` (int8
    only; default kernel E's 256 - 2 ``unit_halo(K)``) is the partition of
    ``ops/quant.py``: float32 and bfloat16 have no windows, so there the
    unit is its two pairs. bfloat16 x and extras: on their float32 values,
    conv1's output float32, the result rounded at the end (``in_f32``)."""
    if check_dot_dtype(dot_dtype) == torch.int8:
        return _amp_unit_int8(x, a1, b1, a2, b2, logscale, w1, bias1, w2,
                              bias2, dilation, tuple(extra_residuals),
                              out_scale, tile)
    t = act_conv1d_plain(x, a1, b1, logscale, w1, bias1, dilation=dilation,
                         dot_dtype=dot_dtype)
    return act_conv1d_plain(t, a2, b2, logscale, w2, bias2, dilation=1,
                            residuals=(x,) + tuple(extra_residuals),
                            out_scale=out_scale, dot_dtype=dot_dtype)


def _amp_unit_int8(x, a1, b1, a2, b2, logscale, w1, bias1, w2, bias2,
                   dilation, extras, out_scale, tile):
    """The int8 unit tile by tile, as kernel E computes it: each tile runs
    conv1 over its outputs plus a halo H on each side with its own act1
    scale, then act2 over that conv1 output and conv2 with its own act2
    scale. Both activations in the kernel's order
    (``snake_activation1d_ordered``)."""
    bsz, c, t = x.shape
    k = w1.shape[-1]
    h = unit_halo(k)
    tile = tile or INT8_TILE - 2 * h
    pad1, pad2 = dilation * (k - 1) // 2, (k - 1) // 2
    n, span = -(-t // tile), tile + 2 * h
    act1 = snake_activation1d_ordered(x, a1, b1, logscale)
    t1 = int8_conv_windows(windows(act1, -h - pad1, span + 2 * pad1, tile, n),
                           w1, dilation)                     # [B, n, C, span]
    if bias1 is not None:
        t1 = t1 + bias1[:, None]

    def act2(seg):
        return snake_activation1d_ordered(seg, a2, b2, logscale)

    # act2 of each tile's conv1 output; its values within 6 samples of a
    # span's end are wrong and unused (act2 reads +-6 samples), except
    # where the span meets the sequence's edge: those tiles take act2 of
    # the span cut to [0, T), whose edges the snake pads as the sequence's
    a = act2(t1.reshape(bsz * n, c, span)).reshape(bsz, n, c, span)
    for i in range(n):
        lo, hi = max(0, h - i * tile), min(span, t - i * tile + h)
        if lo > 0 or hi < span:
            a[:, i, :, lo:hi] = act2(t1[:, i, :, lo:hi])
    # conv2's window: act2 over [t0 - pad2, t0 + tile + pad2), zero outside
    # [0, T)
    off = h - pad2
    pos = (torch.arange(n, device=x.device)[:, None] * tile - pad2
           + torch.arange(tile + 2 * pad2, device=x.device))
    win2 = torch.where(((pos >= 0) & (pos < t))[None, :, None, :],
                       a[..., off:off + tile + 2 * pad2], 0.0)
    y = untile(int8_conv_windows(win2, w2, 1), t)
    if bias2 is not None:
        y = y + bias2[:, None]
    y = y + x
    for e in extras:
        y = y + e
    return y if out_scale == 1.0 else y * out_scale


def act_amax_plain(x: torch.Tensor, alpha: torch.Tensor,
                   beta: Optional[torch.Tensor], logscale: bool, *,
                   stride: int, lo: int, width: int,
                   n_win: int) -> torch.Tensor:
    """The plain version of the int8 instances' pre-pass (the window
    scales' kernel, ``act_amax_kernel`` in csrc/act_conv_core.cuh): x [B,
    C, T] -> [B, n_win, ceil(C / 8)], the largest |a| of the ordered
    activation a = ``snake_activation1d_ordered(x)`` over each window
    [w stride + lo, w stride + lo + width) ∩ [0, T) and each 8 channels
    (zero where a window or a group holds no sample). Kernel D's windows:
    stride 256, lo = -pad, width 256 + 2 pad; kernel E's (act1): stride
    256 - 2 H, lo = -H - pad1, width 256 + 2 pad1."""
    return window_amax(snake_activation1d_ordered(x.float(), alpha, beta,
                                                  logscale),
                       lo, width, stride, n_win, AMAX_CH)


# --- kernel wrappers -------------------------------------------------------------

def _ptr(v: Optional[torch.Tensor]):
    return v.data_ptr() if v is not None else None


def _weights(w: torch.Tensor, dot_dtype: torch.dtype) -> tuple:
    """(pointers, padded sizes) a kernel instance takes for one weight
    tensor [Cout, Cin, K]: the prepared layout [K, Cout_p, Cin_p]
    (``conv_weights``, once per weight tensor; int8 with its [Cout] scales)
    and (Cin_p, Cout_p)."""
    wl = conv_weights(w, dot_dtype)
    ptrs = (wl.data_ptr(),)
    if dot_dtype == torch.int8:
        ptrs += (int8_weights(w)[1].data_ptr(),)
    return ptrs, (wl.shape[2], wl.shape[1])


def _scratch(x: torch.Tensor, n_win: int, dot_dtype: torch.dtype) -> list:
    """The int8 pre-pass's partial maxima, [B, n_win, ceil(C / 8)] floats,
    for an int8 instance; none for the others."""
    if dot_dtype != torch.int8:
        return []
    return [torch.empty((x.shape[0], n_win, -(-x.shape[1] // AMAX_CH)),
                        device=x.device, dtype=torch.float32)]


def _check_act(what: str, c: int, alpha, beta) -> None:
    if alpha.shape != (c,) or (beta is not None and beta.shape != (c,)):
        raise ValueError(f"{what}: alpha/beta must have shape [C] = [{c}]")


def act_conv1d(x: torch.Tensor, alpha: torch.Tensor,
               beta: Optional[torch.Tensor], logscale: bool, w: torch.Tensor,
               b: Optional[torch.Tensor], *, dilation: int,
               residuals: Sequence[torch.Tensor] = (),
               out_scale: float = 1.0,
               dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused snake -> dilated "same" conv with bias, up to three residuals
    and a scale (kernel D). x and the residuals float32 or bfloat16; y
    comes in x's dtype."""
    residuals = tuple(residuals)
    check_dot_dtype(dot_dtype)
    if x.device.type == "cpu":
        return act_conv1d_plain(x, alpha, beta, logscale, w, b,
                                dilation=dilation, residuals=residuals,
                                out_scale=out_scale, dot_dtype=dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"act_conv1d: unsupported device {x.device}")
    if wants_grad(x, alpha, beta, w, b, *residuals):
        raise no_grad_error("act_conv1d", "kernel D")
    bsz, cin, t = x.shape
    cout, cin_w, k = w.shape
    if cin_w != cin or len(residuals) > 3 or bsz > 65535:
        raise ValueError(f"act_conv1d: bad shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} or > 3 residuals")
    if b is not None and b.shape != (cout,):
        raise ValueError("act_conv1d: bias must have shape [Cout]")
    if any(r.shape != (bsz, cout, t) for r in residuals):
        raise ValueError("act_conv1d: residuals must have the output's shape")
    _check_act("act_conv1d", cin, alpha, beta)
    store = _check_maps("act_conv1d", x, residuals, (alpha, beta, w, b))
    if not act_conv_plan(k, dilation, cout, t):
        raise ValueError(f"act_conv1d: no kernel instance for K={k}, "
                         f"dilation={dilation}")
    lib = _build.library("act_conv1d" + STORE_NAME[store])
    y = torch.empty((bsz, cout, t), device=x.device, dtype=store)
    rp = [r.data_ptr() for r in residuals] + [None] * (3 - len(residuals))
    wp, pads = _weights(w, dot_dtype)
    part = _scratch(x, -(-t // INT8_TILE), dot_dtype)
    entry = f"act_conv1d_{DOT_NAME[dot_dtype]}{STORE_NAME[store]}"
    err = getattr(lib, entry)(
        x.data_ptr(), alpha.data_ptr(), _ptr(beta), _filter(x.device).data_ptr(),
        *wp, _ptr(b), rp[0], rp[1], rp[2], y.data_ptr(),
        *(v.data_ptr() for v in part),
        bsz, cin, cout, t, k, dilation, int(logscale), *pads,
        float(out_scale), _stream(x))
    _build.check(err, "act_conv1d")
    count_launch(act_conv1d, dot_dtype, store)
    return y


act_conv1d.launches = 0
act_conv1d.variant_launches = {torch.bfloat16: 0, torch.int8: 0}
act_conv1d.storage_launches = {torch.float32: 0, torch.bfloat16: 0,
                               torch.int8: 0}


def amp_unit(x: torch.Tensor, a1: torch.Tensor, b1: Optional[torch.Tensor],
             a2: torch.Tensor, b2: Optional[torch.Tensor], logscale: bool,
             w1: torch.Tensor, bias1: Optional[torch.Tensor],
             w2: torch.Tensor, bias2: Optional[torch.Tensor], *,
             dilation: int, extra_residuals: Sequence[torch.Tensor] = (),
             out_scale: float = 1.0,
             dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One AMPBlock1 dilation unit, act1 -> conv1 -> act2 -> conv2 -> +x
    (+ up to two extras) x out_scale, in one launch (kernel E). x and the
    extras float32 or bfloat16; y comes in x's dtype."""
    extras = tuple(extra_residuals)
    check_dot_dtype(dot_dtype)
    if x.device.type == "cpu":
        return amp_unit_plain(x, a1, b1, a2, b2, logscale, w1, bias1, w2,
                              bias2, dilation=dilation, extra_residuals=extras,
                              out_scale=out_scale, dot_dtype=dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"amp_unit: unsupported device {x.device}")
    if wants_grad(x, a1, b1, a2, b2, w1, bias1, w2, bias2, *extras):
        raise no_grad_error("amp_unit", "kernel E")
    bsz, c, t = x.shape
    k = w1.shape[-1]
    if (w1.shape != (c, c, k) or w2.shape != (c, c, k) or len(extras) > 2
            or bsz > 65535):
        raise ValueError(f"amp_unit: bad shapes x {tuple(x.shape)} "
                         f"w1 {tuple(w1.shape)} w2 {tuple(w2.shape)} "
                         f"or > 2 extra residuals")
    for bias in (bias1, bias2):
        if bias is not None and bias.shape != (c,):
            raise ValueError("amp_unit: biases must have shape [C]")
    if any(r.shape != x.shape for r in extras):
        raise ValueError("amp_unit: extra residuals must have x's shape")
    _check_act("amp_unit", c, a1, b1)
    _check_act("amp_unit", c, a2, b2)
    store = _check_maps("amp_unit", x, extras,
                        (a1, b1, a2, b2, w1, w2, bias1, bias2))
    if not amp_unit_plan(k, dilation, c, t):
        raise ValueError(f"amp_unit: no kernel instance for K={k}, "
                         f"dilation={dilation}, C={c} (see amp_unit_plan)")
    lib = _build.library("amp_unit" + STORE_NAME[store])
    y = torch.empty_like(x)
    ep = [r.data_ptr() for r in extras] + [None] * (2 - len(extras))
    wp1, pads = _weights(w1, dot_dtype)
    wp2, _ = _weights(w2, dot_dtype)
    part = _scratch(x, -(-t // amp_unit_plan(k, dilation, c, t, dot_dtype)),
                    dot_dtype)
    entry = f"amp_unit_{DOT_NAME[dot_dtype]}{STORE_NAME[store]}"
    err = getattr(lib, entry)(
        x.data_ptr(), a1.data_ptr(), _ptr(b1), a2.data_ptr(), _ptr(b2),
        _filter(x.device).data_ptr(), *wp1, _ptr(bias1), *wp2, _ptr(bias2),
        ep[0], ep[1], y.data_ptr(), *(v.data_ptr() for v in part),
        bsz, c, t, k, dilation, int(logscale), *pads, float(out_scale),
        _stream(x))
    _build.check(err, "amp_unit")
    count_launch(amp_unit, dot_dtype, store)
    return y


amp_unit.launches = 0
amp_unit.variant_launches = {torch.bfloat16: 0, torch.int8: 0}
amp_unit.storage_launches = {torch.float32: 0, torch.bfloat16: 0,
                             torch.int8: 0}
