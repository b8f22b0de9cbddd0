"""The vector field's training step in plain PyTorch: the reference's
``ConditionalFlowMatcherWrapper.forward`` loss (cfm_superresolution.py) and
its optimizer recipe (trainer.py: the gradient clipped to a global norm,
then Adam), float32.

A step on waves ``wave`` and band-limited ``cond`` [B, N] at 48 kHz with
valid ``lengths``: the condition peak-normalised per row, both log-mels
(``dsp.log_mel``), valid frames ceil((length - win) / hop + 1); the
``independent_cfm_adaptive`` path at times t with noise eps:
x_t = t x1 + (1 - t) cond + (1 - (1 - sigma) t) eps, target
(x1 - cond) - (1 - sigma) eps; crops of ``segment_frames`` frames at offset
int(u max(frames - segment, 0)), zero past the valid frames; the field's
prediction on the crop; the squared error's mean over bins, over each row's
valid frames, over rows. Then every gradient is scaled by
max_norm / |g| where the global norm |g| reaches max_norm, and Adam
(bias-corrected, eps outside the root) steps at the cosine schedule's rate.
"""

from __future__ import annotations

import math

import torch

from . import dsp


def loss(net, batch: dict, draws: dict, cfg: dict) -> torch.Tensor:
    mel, seg = cfg["mel"], cfg["train"]["segment_frames"]
    sigma = float(cfg["cfm"]["sigma"])
    wave, cond, lengths = batch["wave"], batch["cond"], batch["lengths"]
    cond = cond / torch.clamp(cond.abs().amax(-1, keepdim=True), min=1e-8)
    x1 = dsp.log_mel(wave, mel).float()
    c = dsp.log_mel(cond, mel).float()
    if x1.shape[1] < seg:  # short waves: zero frames up to one crop
        x1, c = (torch.nn.functional.pad(a, (0, 0, 0, seg - a.shape[1]))
                 for a in (x1, c))
        eps = torch.nn.functional.pad(draws["eps"], (0, 0, 0, seg - draws["eps"].shape[1]))
    else:
        eps = draws["eps"]
    frames = x1.shape[1]
    mel_len = torch.clamp(torch.ceil((lengths - mel["win_length"])
                                     / mel["hop_length"] + 1).long(), 1, frames)
    t = draws["t"][:, None, None]
    x_t = t * x1 + (1 - t) * c + (1 - (1 - sigma) * t) * eps
    target = (x1 - c) - (1 - sigma) * eps
    offset = (draws["crop_u"] * torch.clamp(mel_len - seg, min=0).float()
              ).long().clamp(max=max(frames, seg) - seg)
    rows = offset[:, None] + torch.arange(seg, device=wave.device)[None]
    mask = torch.arange(seg, device=wave.device)[None] < torch.clamp(
        mel_len, max=seg)[:, None]

    def crop(a):
        a = torch.gather(a, 1, rows[..., None].expand(-1, -1, a.shape[-1]))
        return torch.where(mask[..., None], a, 0.0)

    pred = net(crop(x_t), draws["t"], crop(c), mask)
    per_frame = torch.where(mask, ((pred - crop(target)) ** 2).mean(-1), 0.0)
    return (per_frame.sum(-1) / mask.float().sum(-1).clamp(min=1e-5)).mean()


def lr(cfg: dict, update: int) -> float:
    """The cosine schedule (no warm-up steps in the recipe)."""
    t = cfg["train"]
    horizon = float(max(t["num_train_steps"], 1))
    return t["lr"] * 0.5 * (1 + math.cos(math.pi * min(update, horizon)
                                         / horizon))


class Adam:
    """Adam over named tensors (``torch.optim.Adam``'s arithmetic)."""

    def __init__(self, params: dict, b1: float, b2: float, eps: float):
        self.params, self.b1, self.b2, self.eps = params, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, rate: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-rate / c1)


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def steps(net, batches: list, draws: list, cfg: dict) -> dict:
    """Train ``net`` (a ``field.VectorField``) one step a batch: the losses,
    each leaf's first gradient as Adam gets it (after the clip), and each
    leaf's change over the steps, by the reference checkpoint's names."""
    from .field import state_key
    t = cfg["train"]
    params = {state_key(k): p for k, p in net.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, t["adam_b1"], t["adam_b2"], t["adam_eps"])
    losses, first = [], None
    for i, (batch, d) in enumerate(zip(batches, draws)):
        value = loss(net, batch, d, cfg)
        grads = torch.autograd.grad(value, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        grads = clip(grads, t["max_grad_norm"])
        if first is None:
            first = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(grads, lr(cfg, i))
        losses.append(float(value.detach()))
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "grad": first, "change": change}
