"""BigVGAN's discriminators and GAN losses (the vocoder's training side) —
counterpart of ``flowhigh_tpu/models/discriminators.py``.

The multi-period discriminator (MPD) runs Conv2d stacks over the waveform
folded by each period; the multi-resolution discriminator (MRD) runs them
over STFT magnitudes. PyTorch's [B, C, H, W] layout: H = T / p and W = p
(MPD), H = frequency bins and W = frames (MRD); the JAX package's NHWC
maps are the same values transposed.

Every conv is weight-norm parametrised as two parameters, ``weight_g``
[O, 1, 1, 1] and ``weight_v`` [O, I, kH, kW], with ``w = v * g / max(|v|,
1e-12)`` and the norm over (I, kH, kW): an optimizer sees g and v apart,
as optax sees the JAX package's ``*_g`` and ``*_v``. The names are the
reference's (``discriminators.{i}.convs.{j}.weight_v``, ...), so a
module's state dict is the reference's layout. ``use_spectral_norm=True``
raises, as in the JAX package. The convs are the library's ``F.conv2d``
(cuDNN on the card, TF32 off): the JAX package runs them as XLA convs, no
Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..dsp import stft
from ..utils import cudnn_f32

LRELU_SLOPE = 0.1

DEFAULT_PERIODS = (2, 3, 5, 7, 11)
DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

# jax.nn.initializers.lecun_normal: a normal truncated to +-2 standard
# deviations, whose deviation this constant restores to sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def _check_no_spectral_norm(use_spectral_norm: bool) -> None:
    if use_spectral_norm:
        raise NotImplementedError(
            "use_spectral_norm=True is not supported (the reference exposes "
            "it but every published BigVGAN config runs weight norm); "
            "training with it silently disabled would be a different model")


class WNConv2d(nn.Module):
    """A weight-normed Conv2d: ``weight_g``, ``weight_v``, ``bias``."""

    def __init__(self, cin: int, cout: int, kernel: tuple, stride=(1, 1),
                 padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.zeros(cout, cin, *kernel))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True))
        return v * (self.weight_g / torch.clamp(norm, min=1e-12))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with cudnn_f32():
            return F.conv2d(x, self.weight(), self.bias, self.stride,
                            self.padding)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """v lecun-normal (fan-in I kH kW), g = |v| (so the weight is v, as
        torch's ``weight_norm`` at init), bias 0."""
        v = self.weight_v
        std = (v[0].numel() ** -0.5) / _TRUNC_STD
        nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.weight_g.copy_(torch.sqrt(torch.sum(v * v, dim=(1, 2, 3),
                                                 keepdim=True)))
        self.bias.zero_()


def init_discriminator_(module: nn.Module, seed: int) -> nn.Module:
    """Every ``WNConv2d`` of ``module`` reset from one CPU generator seeded
    ``seed``, in module order (call before moving the module to a device,
    so the card and the CPU start from the same weights)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, WNConv2d):
            m.reset_parameters(gen)
    return module


def _stack(x: torch.Tensor, convs: nn.ModuleList,
           post: WNConv2d) -> tuple[torch.Tensor, list]:
    """The convs with leaky ReLU, then the post conv: (scores [B, H W],
    the six feature maps)."""
    fmap = []
    for conv in convs:
        x = F.leaky_relu(conv(x), LRELU_SLOPE)
        fmap.append(x)
    x = post(x)
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


class DiscriminatorP(nn.Module):
    """Period discriminator: [B, T] reflect-padded to a multiple of the
    period, folded to [B, 1, T / p, p]."""

    def __init__(self, period: int, d_mult: int = 1, kernel_size: int = 5,
                 stride: int = 3, use_spectral_norm: bool = False):
        super().__init__()
        _check_no_spectral_norm(use_spectral_norm)
        self.period = period
        chans = [int(32 * d_mult), int(128 * d_mult), int(512 * d_mult),
                 int(1024 * d_mult)]
        pad = (kernel_size - 1) // 2
        convs, cin = [], 1
        for cout in chans:
            convs.append(WNConv2d(cin, cout, (kernel_size, 1), (stride, 1),
                                  (pad, 0)))
            cin = cout
        convs.append(WNConv2d(cin, cin, (kernel_size, 1), padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(cin, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list]:
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None, :], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[-1]
        return _stack(x.reshape(b, 1, t // p, p), self.convs, self.conv_post)


class DiscriminatorR(nn.Module):
    """Resolution discriminator over the STFT magnitude [B, 1, bins,
    frames]: reflect padding of (n_fft - hop) / 2 a side, no centring, a
    rectangular window of ``win`` samples, sqrt(re^2 + im^2) in float32
    (``_magnitude``)."""

    def __init__(self, resolution: Sequence[int], d_mult: int = 1,
                 use_spectral_norm: bool = False):
        super().__init__()
        _check_no_spectral_norm(use_spectral_norm)
        self.resolution = tuple(resolution)
        c = int(32 * d_mult)
        specs = [((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                 ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                 ((3, 3), (1, 1), (1, 1))]
        self.convs = nn.ModuleList([
            WNConv2d(1 if i == 0 else c, c, k, s, p)
            for i, (k, s, p) in enumerate(specs)])
        self.conv_post = WNConv2d(c, 1, (3, 3), padding=(1, 1))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list]:
        n_fft, hop, win = self.resolution
        spec = stft(x.float(), n_fft, hop, win, center=False,
                    pad_mode="reflect", window="rect")
        return _stack(_magnitude(spec)[:, None], self.convs, self.conv_post)


def _magnitude(spec: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2), the JAX package's magnitude (eps 0), whose
    gradient at a zero bin is 0, as ``torch.abs``'s in the reference: the
    plain square root's is 0 x inf = NaN there, and a generator whose
    output saturates at +-1 gives constant frames, whose FFT has exact
    zeros (the bins k with k win = 0 mod n_fft)."""
    power = spec.real * spec.real + spec.imag * spec.imag
    nonzero = power > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, power, 1.0)),
                       0.0)


def _ensemble(discs: nn.ModuleList, y: torch.Tensor, y_hat: torch.Tensor):
    outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
    for d in discs:
        o_r, f_r = d(y)
        o_g, f_g = d(y_hat)
        outs_r.append(o_r)
        outs_g.append(o_g)
        fmaps_r.append(f_r)
        fmaps_g.append(f_g)
    return outs_r, outs_g, fmaps_r, fmaps_g


class MultiPeriodDiscriminator(nn.Module):
    """One ``DiscriminatorP`` a period, as ``discriminators.{i}``.
    ``forward(y, y_hat)`` ([B, T] each) -> (scores of y, scores of y_hat,
    feature maps of y, feature maps of y_hat), one entry a period."""

    def __init__(self, periods: Sequence[int] = DEFAULT_PERIODS,
                 d_mult: int = 1, use_spectral_norm: bool = False):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList([
            DiscriminatorP(p, d_mult, use_spectral_norm=use_spectral_norm)
            for p in self.periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _ensemble(self.discriminators, y, y_hat)


class MultiResolutionDiscriminator(nn.Module):
    """One ``DiscriminatorR`` a resolution (n_fft, hop, win), as
    ``discriminators.{i}``; ``forward`` as the MPD's."""

    def __init__(self, resolutions: Sequence[Sequence[int]] =
                 DEFAULT_RESOLUTIONS, d_mult: int = 1,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.resolutions = tuple(tuple(r) for r in resolutions)
        self.discriminators = nn.ModuleList([
            DiscriminatorR(r, d_mult, use_spectral_norm=use_spectral_norm)
            for r in self.resolutions])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _ensemble(self.discriminators, y, y_hat)


# --- the GAN losses: LS-GAN and feature matching ---------------------------------

def feature_loss(fmaps_r, fmaps_g) -> torch.Tensor:
    """2 x the sum over every feature map of mean |real - generated|."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(outs_r, outs_g):
    """(sum of mean (1 - D(real))^2 + mean D(fake)^2, the real terms, the
    fake terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(outs_r, outs_g):
        r = torch.mean(torch.square(1.0 - dr))
        g = torch.mean(torch.square(dg))
        loss = loss + (r + g)
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(outs_g):
    """(sum of mean (1 - D(fake))^2, the terms)."""
    loss = 0.0
    gen_losses = []
    for dg in outs_g:
        term = torch.mean(torch.square(1.0 - dg))
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses


__all__ = ["DiscriminatorP", "DiscriminatorR", "MultiPeriodDiscriminator",
           "MultiResolutionDiscriminator", "WNConv2d", "init_discriminator_",
           "feature_loss", "discriminator_loss", "generator_loss",
           "LRELU_SLOPE", "DEFAULT_PERIODS", "DEFAULT_RESOLUTIONS"]
