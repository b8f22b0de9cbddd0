"""BigVGAN's generator (resblock "1", snake-beta activations) in plain
PyTorch, float32, as a function of its weights.

Written from the reference's models.py and alias-free activation: conv_pre
(kernel 7) -> per stage a transposed conv (stride u, kernel k, padding
(k - u) / 2) and the mean of three AMP blocks -> activation -> conv_post
(kernel 7, one channel) -> tanh. An AMP block is three units of
act -> dilated conv -> act -> conv, each added to its input. An activation
upsamples 2x (replicate padding, transposed conv with a 12-tap Kaiser-sinc
filter, crop), applies x + sin^2(e^alpha x) / (e^beta + 1e-9), and
downsamples 2x (replicate padding, the same filter, stride 2).

The weights are a dict in the reference checkpoint's names with folded
``.weight`` entries (``fold`` turns its ``weight_g`` / ``weight_v`` pairs
into them: w = g v / |v|, the norm over every dimension but the first, as
``torch.nn.utils.weight_norm`` does).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def fold(sd: dict) -> dict:
    """Weight-normed state dict -> folded weights (a new dict)."""
    out = {}
    for key, val in sd.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            g = sd[key[:-len("_v")] + "_g"]
            dims = tuple(range(1, val.ndim))
            norm = torch.sqrt(torch.sum(val.double() ** 2, dim=dims,
                                        keepdim=True))
            out[key[:-len("_v")]] = (g.double() * val.double()
                                     / norm).to(val.dtype)
        else:
            out[key] = val
    return out


def kaiser_sinc(cutoff: float, half_width: float, size: int) -> np.ndarray:
    half = size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(size, beta)
    t = (np.arange(-half, half) + 0.5 if size % 2 == 0
         else np.arange(size) - half)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    return filt / filt.sum()


def _taps(x: torch.Tensor) -> torch.Tensor:
    f = torch.tensor(kaiser_sinc(0.25, 0.3, 12), dtype=x.dtype,
                     device=x.device)
    return f.reshape(1, 1, 12).expand(x.shape[1], 1, 12)


def activation(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    c, f = x.shape[1], _taps(x)
    up = F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), f, stride=2,
                            groups=c) * 2.0
    up = up[..., 15:up.shape[-1] - 15]
    a, b = alpha.exp()[None, :, None], beta.exp()[None, :, None]
    y = up + torch.sin(up * a) ** 2 / (b + 1e-9)
    return F.conv1d(F.pad(y, (5, 6), mode="replicate"), f, stride=2,
                    groups=c)


def conv(x, w: dict, name: str, dilation: int = 1) -> torch.Tensor:
    weight = w[name + ".weight"]
    k = weight.shape[-1]
    return F.conv1d(x, weight, w[name + ".bias"], dilation=dilation,
                    padding=(k * dilation - dilation) // 2)


def amp_block(x, w: dict, base: str, kernel: int, dilations) -> torch.Tensor:
    for j, d in enumerate(dilations):
        a1, a2 = f"{base}.activations.{2 * j}.act", \
            f"{base}.activations.{2 * j + 1}.act"
        h = activation(x, w[a1 + ".alpha"], w[a1 + ".beta"])
        h = conv(h, w, f"{base}.convs1.{j}", d)
        h = activation(h, w[a2 + ".alpha"], w[a2 + ".beta"])
        x = conv(h, w, f"{base}.convs2.{j}") + x
    return x


def generator(mel: torch.Tensor, w: dict, voc: dict) -> torch.Tensor:
    """mel [B, frames, n_mels] -> waveform [B, frames * prod(rates)].
    ``voc``: the configuration's ``vocoder`` group."""
    x = conv(mel.transpose(1, 2), w, "conv_pre")
    kernels, dils = voc["resblock_kernel_sizes"], voc["resblock_dilation_sizes"]
    nk = len(kernels)
    for i, (u, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(x, w[f"ups.{i}.0.weight"], w[f"ups.{i}.0.bias"],
                               stride=u, padding=(k - u) // 2)
        acc = None
        for j in range(nk):
            y = amp_block(x, w, f"resblocks.{i * nk + j}", kernels[j], dils[j])
            acc = y if acc is None else acc + y
        x = acc / nk
    x = activation(x, w["activation_post.act.alpha"],
                   w["activation_post.act.beta"])
    return torch.tanh(conv(x, w, "conv_post"))[:, 0]
