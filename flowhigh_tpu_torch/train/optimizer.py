"""Optimizer and learning-rate schedule — counterpart of
``flowhigh_tpu/train/optimizer.py``, which builds them with optax.

The recipe: gradients clipped to a global norm of ``max_grad_norm`` (0.5),
then Adam (0.9, 0.99), or AdamW with the decay on >= 2-D parameters only;
the learning rate warms up linearly from ``initial_lr`` over
``num_warmup_steps`` updates, then follows a cosine to 0 over
``num_train_steps``. With ``grad_accum_every = k`` the gradients of k
micro-steps are averaged (optax.MultiSteps' running mean) and clipped and
applied once. Adam itself is ``torch.optim.Adam`` / ``AdamW``; the clip,
the accumulation and the schedule are written here to optax's formulas.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from ..config import TrainConfig


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """update index -> learning rate: optax.join_schedules of
    ``linear_schedule(initial_lr, lr, warmup)`` and
    ``cosine_decay_schedule(lr, max(num_train_steps, 1), 0)``, the cosine
    fed ``step - warmup`` (just the cosine without warmup)."""
    warmup = cfg.num_warmup_steps
    horizon = float(max(cfg.num_train_steps, 1))

    def cosine(count) -> float:
        count = min(float(count), horizon)
        return cfg.lr * (0.5 * (1 + math.cos(math.pi * count / horizon)))

    if warmup <= 0:
        return cosine

    def schedule(step) -> float:
        if step < warmup:
            frac = 1 - min(max(step, 0), warmup) / warmup
            return (cfg.initial_lr - cfg.lr) * frac + cfg.lr
        return cosine(step - warmup)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``tensors``, on
    their device (no read-back)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in tensors]))


class Optimizer:
    """optax's ``chain(clip_by_global_norm, adam | adamw)``, in
    ``MultiSteps`` when ``grad_accum_every > 1``, over ``params``.

    ``step()`` takes each parameter's ``.grad`` (None counts as zeros, as
    optax sees a leaf that the loss does not reach) as one micro-step. On
    the k-th it clips the micro-steps' mean and applies Adam at
    ``schedule(updates)``, and returns True; before it, only the running
    mean moves and parameters stay as they are.

    ``norm`` maps the gradients (aligned with ``params``) to their global
    norm: ``global_norm`` by default; under tensor parallelism
    ``parallel.tensor.sharded_norm``, which sums the sharded weights'
    squares over the ``model`` group."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TrainConfig, norm: Optional[Callable] = None):
        self.params = list(params)
        self.norm = norm or global_norm
        self.schedule = lr_schedule(cfg)
        self.k = max(cfg.grad_accum_every, 1)
        self.max_norm = float(cfg.max_grad_norm)
        kw = dict(lr=self.schedule(0), betas=(cfg.adam_b1, cfg.adam_b2),
                  eps=cfg.adam_eps)
        if cfg.weight_decay > 0:  # decay_mask: >= 2-D params only
            self.inner = torch.optim.AdamW(
                [{"params": [p for p in self.params if p.ndim >= 2]},
                 {"params": [p for p in self.params if p.ndim < 2],
                  "weight_decay": 0.0}],
                weight_decay=cfg.weight_decay, **kw)
        else:
            self.inner = torch.optim.Adam(self.params, **kw)
        self.mini_step = 0   # micro-steps into the current update
        self.updates = 0     # updates applied (the schedule's count)
        self.acc: Optional[list] = None

    def step(self) -> bool:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.k > 1:  # Welford mean of the micro-steps' gradients
            n = self.mini_step
            acc = self.acc or [torch.zeros_like(p) for p in self.params]
            grads = [a + (g - a) / (n + 1) for a, g in zip(acc, grads)]
            self.mini_step = (n + 1) % self.k
            self.acc = grads if self.mini_step else None
            if self.mini_step:
                return False
        norm = self.norm(grads)
        keep = norm < self.max_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, (g / norm) * self.max_norm)
        lr = self.schedule(self.updates)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "updates": self.updates, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.mini_step, self.updates = sd["mini_step"], sd["updates"]
        self.acc = (None if sd["acc"] is None else
                    [a.to(p.device) for a, p in zip(sd["acc"], self.params)])


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   norm: Optional[Callable] = None) -> Optimizer:
    """The training recipe's ``Optimizer`` over ``params`` (``norm``: see
    ``Optimizer``)."""
    return Optimizer(params, cfg, norm)
