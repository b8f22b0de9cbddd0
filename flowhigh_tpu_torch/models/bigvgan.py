"""BigVGAN 48 kHz 256-band generator — counterpart of
``flowhigh_tpu/models/bigvgan.py`` (resblock "1", ``AMPBlock1``, and
resblock "2", ``AMPBlock2``).

PyTorch's [B, C, T] layout inside; the public ``BigVGAN.forward`` takes the
JAX package's [B, frames, n_mels] mel and returns [B, T_wav]. Weights keep
the reference PyTorch state-dict layout (``tests/torch_ref.py:TorchBigVGAN``
with weight norm folded): ``conv_pre``, ``ups.{i}.0``,
``resblocks.{n}.convs{1,2}.{j}`` (``resblocks.{n}.convs.{j}`` for
AMPBlock2), ``resblocks.{n}.activations.{m}.act``, ``activation_post``,
``conv_post``, plus the alias-free filter buffers.

The hot path runs through the port's five kernels. ``fuse_act_conv``
chooses, as in the JAX package (``flowhigh_tpu/models/bigvgan.py:
AMPBlock1``), how each AMPBlock1 dilation unit runs:

- ``True`` (the default): the whole unit in one launch (kernel E) where
  ``ops.amp_unit_plan`` fits it, else each [act -> conv] pair in one launch
  (kernel D) where ``ops.act_conv_plan`` fits it, else the snake (kernel A)
  and the conv (kernel B) apart;
- ``"pairs"``: kernel D for every pair that fits, no units;
- ``"auto"``: kernel D for the k <= 3 pairs only;
- ``False``: kernels A and B for everything.

The MRF branch average is folded into the last branch's final kernel as
residual + extras x 1/num_kernels. ``AMPBlock2`` (per dilation: act ->
dilated conv -> + x) runs each act on kernel A and each conv on kernel B
with x as its residual, whatever ``fuse_act_conv`` says, and its MRF
average is a sum and a divide, as in the JAX package, which folds the
average for AMPBlock1 only. ``activation_post`` and ``conv_post``
run on kernels A and B, the upsamplers on kernel C; ``conv_pre`` is a
plain ``F.conv1d``. An upsampler whose K - stride is odd (none in the
published config) runs the library transposed conv in float32 instead, by
the JAX package's rule (``flowhigh_tpu/models/bigvgan.py``: such a pair
goes to XLA's ``conv_transpose1d``, outside any kernel, with no dot
dtype); the class counter ``BigVGAN.library_upsamplers`` counts those
calls.

``conv_dtype`` (``None`` = float32, ``torch.bfloat16``, ``torch.int8``) is
the JAX package's ``BigVGAN.conv_dtype``: the dot precision of every
resblock conv (kernels B, D, E; ``ops/quant.py``). The stage-boundary
convs follow the JAX package's ``_boundary_dtype``: bfloat16 for the
upsamplers and ``conv_post`` under bfloat16, float32 under int8.
``conv_pre`` and the snakes stay float32, and every feature map stays
float32 in device memory.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import scipy.signal as sps
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VocoderConfig
from ..ops import (act_conv1d, act_conv_plan, amp_unit, amp_unit_plan, conv1d,
                   conv_transpose1d, snake_activation1d)
from ..ops.quant import check_dot_dtype
from ..utils import cudnn_f32


@functools.lru_cache(maxsize=32)
def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, the reference's alias-free filter."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = sps.windows.kaiser(kernel_size, beta, sym=True)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _depthwise_filter(x: torch.Tensor, k: int, ratio: int) -> torch.Tensor:
    filt = torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k))
    return filt.to(x.device).reshape(1, 1, k).expand(x.shape[1], 1, k)


def upsample1d(x: torch.Tensor, ratio: int = 2,
               kernel_size: Optional[int] = None) -> torch.Tensor:
    """Anti-aliased upsample of [B, C, T]: replicate pad, depthwise
    transposed conv with the Kaiser-sinc filter, crop."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    xp = F.pad(x, (pad, pad), mode="replicate")
    with cudnn_f32():
        y = ratio * F.conv_transpose1d(xp, _depthwise_filter(x, k, ratio),
                                       stride=ratio, groups=x.shape[1])
    return y[..., pad_left: y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2,
                 kernel_size: Optional[int] = None) -> torch.Tensor:
    """Anti-aliased strided low-pass of [B, C, T] (replicate padding)."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    even = k % 2 == 0
    xp = F.pad(x, (k // 2 - int(even), k // 2), mode="replicate")
    with cudnn_f32():
        return F.conv1d(xp, _depthwise_filter(x, k, ratio), stride=ratio,
                        groups=x.shape[1])


def _per_channel(p: torch.Tensor, logscale: bool) -> torch.Tensor:
    p = p[None, :, None]
    return torch.exp(p) if logscale else p


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool) -> torch.Tensor:
    """x + (1/a) sin^2(a x), per-channel alpha, [B, C, T]."""
    a = _per_channel(alpha, logscale)
    return x + (1.0 / (a + 1e-9)) * torch.sin(x * a) ** 2


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               logscale: bool) -> torch.Tensor:
    """x + (1/b) sin^2(a x), [B, C, T]."""
    a, b = _per_channel(alpha, logscale), _per_channel(beta, logscale)
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


class SnakeParams(nn.Module):
    """Per-channel (log-)alpha and (log-)beta of one snake activation."""

    def __init__(self, channels: int, activation: str = "snakebeta",
                 logscale: bool = True):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = (nn.Parameter(init(channels))
                     if activation == "snakebeta" else None)


class _FilterBuffer(nn.Module):
    """Holds the reference layout's ``filter`` buffer [1, 1, 12]; the
    kernels and their plain versions build the same taps themselves."""

    def __init__(self):
        super().__init__()
        self.register_buffer("filter", torch.from_numpy(
            kaiser_sinc_filter1d(0.25, 0.3, 12)).reshape(1, 1, 12))


class Activation1d(nn.Module):
    """2x upsample -> snake(beta) -> 2x downsample, as kernel A."""

    def __init__(self, channels: int, activation: str = "snakebeta",
                 logscale: bool = True):
        super().__init__()
        if activation not in ("snake", "snakebeta"):
            raise ValueError(f"unknown activation {activation!r}")
        self.logscale = logscale
        self.upsample = _FilterBuffer()
        self.act = SnakeParams(channels, activation, logscale)
        self.downsample = _FilterBuffer()

    def forward(self, x):
        return snake_activation1d(x, self.act.alpha, self.act.beta,
                                  self.logscale)


class AMPBlock1(nn.Module):
    """3x [act -> dilated conv -> act -> conv] + residual."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int], activation: str = "snakebeta",
                 logscale: bool = True, fuse_act_conv=True,
                 dot_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not (fuse_act_conv is True or fuse_act_conv is False
                or fuse_act_conv in ("auto", "pairs")):
            raise ValueError("fuse_act_conv must be True, False, 'auto' or "
                             f"'pairs', got {fuse_act_conv!r}")
        self.fuse_act_conv = fuse_act_conv
        self.dot_dtype = check_dot_dtype(dot_dtype)
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2)
            for d in self.dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size,
                      padding=(kernel_size - 1) // 2)
            for _ in self.dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, logscale)
            for _ in range(2 * len(self.dilations))])

    def _act_then_conv(self, x, act: "Activation1d", conv: nn.Conv1d,
                       dilation: int, residuals=(), out_scale: float = 1.0):
        """act -> conv as one kernel-D launch where the plan fits it, else
        kernel A then kernel B."""
        k = conv.weight.shape[-1]
        fuse = k <= 3 if self.fuse_act_conv == "auto" else bool(
            self.fuse_act_conv)
        if fuse and act_conv_plan(k, dilation, x.shape[1], x.shape[-1]):
            return act_conv1d(x, act.act.alpha, act.act.beta, act.logscale,
                              conv.weight, conv.bias, dilation=dilation,
                              residuals=residuals, out_scale=out_scale,
                              dot_dtype=self.dot_dtype)
        return conv1d(act(x), conv.weight, conv.bias, dilation=dilation,
                      residuals=residuals, out_scale=out_scale,
                      dot_dtype=self.dot_dtype)

    def forward(self, x, extra_residuals: Sequence[torch.Tensor] = (),
                out_scale: float = 1.0):
        """``extra_residuals``/``out_scale`` apply to the last conv only:
        out = out_scale * (conv + x + sum(extra_residuals))."""
        n_last = len(self.dilations) - 1
        for j, d in enumerate(self.dilations):
            c1, c2 = self.convs1[j], self.convs2[j]
            a1, a2 = self.activations[2 * j], self.activations[2 * j + 1]
            last = j == n_last
            extras = tuple(extra_residuals) if last else ()
            scale = out_scale if last else 1.0
            k = c1.weight.shape[-1]
            if self.fuse_act_conv is True and amp_unit_plan(
                    k, d, x.shape[1], x.shape[-1]):
                x = amp_unit(x, a1.act.alpha, a1.act.beta, a2.act.alpha,
                             a2.act.beta, a1.logscale, c1.weight, c1.bias,
                             c2.weight, c2.bias, dilation=d,
                             extra_residuals=extras, out_scale=scale,
                             dot_dtype=self.dot_dtype)
                continue
            xt = self._act_then_conv(x, a1, c1, d)
            x = self._act_then_conv(xt, a2, c2, 1, residuals=(x,) + extras,
                                    out_scale=scale)
        return x


class AMPBlock2(nn.Module):
    """Per dilation: act -> dilated conv -> + x (the JAX package's
    ``AMPBlock2``, one conv per dilation)."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int], activation: str = "snakebeta",
                 logscale: bool = True,
                 dot_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dot_dtype = check_dot_dtype(dot_dtype)
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2)
            for d in self.dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, logscale)
            for _ in self.dilations])

    def forward(self, x):
        for d, act, conv in zip(self.dilations, self.activations, self.convs):
            x = conv1d(act(x), conv.weight, conv.bias, dilation=d,
                       residuals=(x,), dot_dtype=self.dot_dtype)
        return x


class BigVGAN(nn.Module):
    """conv_pre -> [upsample -> MRF average]* -> act -> conv_post -> tanh."""

    # calls of the library transposed conv (odd K - stride), over every
    # instance, like the kernel wrappers' ``launches``
    library_upsamplers = 0

    def __init__(self, cfg: VocoderConfig = VocoderConfig(),
                 fuse_act_conv=True, conv_dtype: Optional[torch.dtype] = None):
        """``fuse_act_conv``: True | False | "auto" | "pairs"; ``conv_dtype``:
        None (float32) | torch.bfloat16 | torch.int8 (see the module
        docstring)."""
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', got "
                             f"{cfg.resblock!r}")
        self.cfg = cfg
        self.conv_dtype = check_dot_dtype(conv_dtype or torch.float32)
        # the JAX package's _boundary_dtype: int8 quantises resblocks only
        self.boundary_dtype = (torch.float32 if self.conv_dtype == torch.int8
                               else self.conv_dtype)
        ch = cfg.upsample_initial_channel
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
            self.ups.append(nn.ModuleList([
                nn.ConvTranspose1d(cin, cout, k, u, padding=(k - u) // 2)]))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(
                    AMPBlock1(cout, rk, rd, cfg.activation,
                              cfg.snake_logscale, fuse_act_conv,
                              self.conv_dtype) if cfg.resblock == "1" else
                    AMPBlock2(cout, rk, rd, cfg.activation,
                              cfg.snake_logscale, self.conv_dtype))
        self.activation_post = Activation1d(cout, cfg.activation,
                                            cfg.snake_logscale)
        self.conv_post = nn.Conv1d(cout, 1, 7, padding=3)

    def _upsample(self, x, up: nn.ConvTranspose1d, u: int):
        """Kernel C where K - u is even (exactly u * T outputs), else the
        library transposed conv in float32."""
        k = up.weight.shape[-1]
        if (k - u) % 2 == 0:
            return conv_transpose1d(x, up.weight, up.bias, stride=u,
                                    dot_dtype=self.boundary_dtype)
        BigVGAN.library_upsamplers += 1
        with cudnn_f32():
            return F.conv_transpose1d(x, up.weight, up.bias, stride=u,
                                      padding=(k - u) // 2)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, frames, n_mels] -> waveform [B, frames * prod(rates)]."""
        with cudnn_f32():
            x = self.conv_pre(mel.transpose(1, 2).contiguous())
        nk = self.num_kernels
        for i, u in enumerate(self.cfg.upsample_rates):
            x = self._upsample(x, self.ups[i][0], u)
            blocks = self.resblocks[i * nk:(i + 1) * nk]
            if self.cfg.resblock == "2":  # the MRF average, summed apart
                ys = [block(x) for block in blocks]
                acc = ys[0]
                for y in ys[1:]:
                    acc = acc + y
                x = acc / nk
                continue
            ys: list = []
            for j, block in enumerate(blocks):
                if j == nk - 1:  # the MRF average, folded into the last conv
                    ys.append(block(x, extra_residuals=ys, out_scale=1.0 / nk))
                else:
                    ys.append(block(x))
            x = ys[-1]
        x = self.activation_post(x)
        x = conv1d(x, self.conv_post.weight, self.conv_post.bias,
                   dot_dtype=self.boundary_dtype)
        return torch.tanh(x)[:, 0, :]
