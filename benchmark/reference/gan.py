"""BigVGAN's GAN training step in plain PyTorch, float32: the recipe of the
reference's train.py for the generator and its discriminators.

A step on waves [B, segment_samples] at 48 kHz: their log-mels
(``dsp.log_mel``, no gradient); the generator's wave from the first
``segment_frames`` frames, cut to the segment; the discriminators' update
on it (detached), by their LS-GAN loss and Adam; then the generator's
update against the updated discriminators: its adversarial and feature
losses plus ``mel_loss_weight`` x the mean |log-mel(fake) - log-mel(real)|,
and Adam. Both Adams at a constant rate. The generator's weights are
folded (its convs' ``weight``), the discriminators' weight-normed
(``weight_g`` and ``weight_v`` apart), as the program trains them.
"""

from __future__ import annotations

import torch

from . import discriminators as disc
from . import dsp, vocoder
from .train import Adam


def steps(gen_w: dict, disc_w: dict, waves: list, cfg: dict) -> dict:
    """One step a batch of ``waves``: the losses, each leaf's first
    gradient as its Adam gets it and its change over the steps (generator
    leaves by the checkpoint's names, the discriminators' under ``mpd.`` /
    ``mrd.``)."""
    g, voc, mel = cfg["gan"], cfg["vocoder"], cfg["mel"]
    gen = {k: v.detach().clone().requires_grad_(True)
           for k, v in gen_w.items() if not k.endswith(".filter")}
    dis = {k: v.detach().clone().requires_grad_(True)
           for k, v in disc_w.items()}
    start = {**{k: v.detach().clone() for k, v in gen.items()},
             **{k: v.detach().clone() for k, v in dis.items()}}
    betas = (g["adam_b1"], g["adam_b2"])
    opt_g = Adam(gen, *betas, g["adam_eps"])
    opt_d = Adam(dis, *betas, g["adam_eps"])
    seg = g["segment_frames"]
    losses = {"disc_loss": [], "gen_loss": [], "mel_l1": []}
    first = None
    for wave in waves:
        wav = wave[:, :seg * mel["hop_length"]]
        with torch.no_grad():
            mel_real = dsp.log_mel(wav, mel).float()
        fake = vocoder.generator(mel_real[:, :seg], gen, voc)[:, :wav.shape[1]]
        outs = disc.ensemble(wav, fake.detach(), dis, g["periods"],
                             g["resolutions"])
        d_loss = disc.disc_loss(outs)
        d_grads = dict(zip(dis, torch.autograd.grad(d_loss, list(dis.values()))))
        opt_d.step(d_grads, g["lr"])
        frozen = {k: v.detach() for k, v in dis.items()}
        outs = disc.ensemble(wav, fake, frozen, g["periods"], g["resolutions"])
        l_mel = torch.mean(torch.abs(dsp.log_mel(fake, mel).float() - mel_real)
                           ) * g["mel_loss_weight"]
        g_loss = disc.gen_adversarial(outs) + l_mel
        g_grads = dict(zip(gen, torch.autograd.grad(g_loss, list(gen.values()))))
        opt_g.step(g_grads, g["lr"])
        if first is None:
            first = {k: float(v.norm()) for k, v in {**g_grads,
                                                      **d_grads}.items()}
        for name, value in (("disc_loss", d_loss), ("gen_loss", g_loss),
                            ("mel_l1", l_mel)):
            losses[name].append(float(value.detach()))
    change = {k: float((v.detach() - start[k]).norm())
              for k, v in {**gen, **dis}.items()}
    return {"losses": losses, "grad": first, "change": change}
