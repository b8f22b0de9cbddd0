"""BigVGAN's discriminators and GAN losses in plain PyTorch, float32, as
functions of their weight-normed weights (``weight_g``, ``weight_v``,
``bias``: w = g v / |v|, the norm over every dimension but the first).

Written from the reference's models.py:

- a period discriminator folds the wave [B, T] (reflect-padded on the
  right to a multiple of the period p) to [B, 1, T / p, p] and runs convs of
  kernel (5, 1), stride (3, 1), padding (2, 0) to 32, 128, 512 and 1024
  channels, one more of stride 1 at 1024, each with a leaky ReLU of slope
  0.1, and a (3, 1) conv to one channel;
- a resolution discriminator (n_fft, hop, win) takes |STFT| [B, 1, bins,
  frames] (reflect padding of (n_fft - hop) / 2 a side, no centring, a
  rectangular window of win samples) through 32-channel convs of kernels
  (3, 9), (3, 9) x 3 at stride (1, 2) and (3, 3), the leaky ReLU, and a
  (3, 3) conv to one channel;
- the losses: the discriminators' LS-GAN sum of mean (1 - D(real))^2 and
  mean D(fake)^2; the generator's sum of mean (1 - D(fake))^2, twice the
  sum over every feature map of mean |real - fake|.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SLOPE = 0.1


def _conv(x, w: dict, name: str, stride=(1, 1), padding=(0, 0)):
    v, g = w[name + ".weight_v"], w[name + ".weight_g"]
    norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True))
    return F.conv2d(x, g * v / norm, w[name + ".bias"], stride, padding)


def _stack(x, w: dict, base: str, specs, post_padding) -> tuple:
    fmap = []
    for j, (stride, padding) in enumerate(specs):
        x = F.leaky_relu(_conv(x, w, f"{base}.convs.{j}", stride, padding),
                         SLOPE)
        fmap.append(x)
    x = _conv(x, w, f"{base}.conv_post", padding=post_padding)
    fmap.append(x)
    return torch.flatten(x, 1), fmap


def period(x, w: dict, base: str, p: int):
    b, t = x.shape
    if t % p:
        x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
        t = x.shape[-1]
    specs = [((3, 1), (2, 0))] * 4 + [((1, 1), (2, 0))]
    return _stack(x.reshape(b, 1, t // p, p), w, base, specs, (1, 0))


def resolution(x, w: dict, base: str, res):
    n_fft, hop, win = res
    pad = (n_fft - hop) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(x, n_fft, hop, win, window=torch.ones(
        win, device=x.device), center=False, return_complex=True)
    specs = [((1, 1), (1, 4))] + [((1, 2), (1, 4))] * 3 + [((1, 1), (1, 1))]
    return _stack(spec.abs()[:, None], w, base, specs, (1, 1))


def ensemble(real, fake, w: dict, periods, resolutions):
    """[(scores of real, of fake, maps of real, of fake)] of every
    discriminator, the MPD's (``mpd.discriminators.i``) then the MRD's."""
    out = []
    for i, p in enumerate(periods):
        base = f"mpd.discriminators.{i}"
        r, f = period(real, w, base, p), period(fake, w, base, p)
        out.append((r[0], f[0], r[1], f[1]))
    for i, res in enumerate(resolutions):
        base = f"mrd.discriminators.{i}"
        r, f = resolution(real, w, base, res), resolution(fake, w, base, res)
        out.append((r[0], f[0], r[1], f[1]))
    return out


def disc_loss(outs) -> torch.Tensor:
    return sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2)
               for r, g, _, _ in outs)


def gen_adversarial(outs) -> torch.Tensor:
    adv = sum(torch.mean((1 - g) ** 2) for _, g, _, _ in outs)
    feat = sum(torch.mean(torch.abs(a - b)) for _, _, fr, fg in outs
               for a, b in zip(fr, fg))
    return adv + 2.0 * feat
