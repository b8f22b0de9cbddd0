"""Conditional flow matching at inference: cutoff search, prior, fixed-grid
ODE solvers — counterpart of the sampling half of ``flowhigh_tpu/cfm.py``.

The cutoff-frequency search is a cumsum + comparison count (no host sync),
and the euler/midpoint solvers match ``torchdiffeq.odeint`` on
``linspace(0, 1, steps + 1)``. Noise comes from an explicit
``torch.Generator``; with the reference's executed prior (``std_2 = sigma =
0``) the prior is ``cond`` itself and no random number reaches the output.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .config import CFMConfig

CFM_METHODS = CFMConfig.CFM_METHODS


def cutoff_bins_from_energy(energy_per_bin: torch.Tensor,
                            percentile: float) -> torch.Tensor:
    """energy_per_bin: [..., n_bins] nonneg. The largest bin whose cumulative
    energy is below ``percentile`` of the total, or 0."""
    csum = torch.cumsum(energy_per_bin, dim=-1)
    thr = csum[..., -1:] * percentile
    below = torch.sum((csum < thr).to(torch.int64), dim=-1)
    return torch.clamp(below - 1, min=0)


def mel_cutoff_bins(mel: torch.Tensor, percentile: float = 0.9995) -> torch.Tensor:
    """[B, T, n_mels] log-mel -> [B] cutoff mel bin (exp(mel) summed over time)."""
    energy = torch.sum(torch.exp(mel), dim=-2)
    return cutoff_bins_from_energy(energy, percentile)


def mel_replace(high: torch.Tensor, low: torch.Tensor,
                cutoff: torch.Tensor) -> torch.Tensor:
    """Bins < cutoff from ``low``, >= cutoff from ``high``, per batch item."""
    bins = torch.arange(high.shape[-1], device=high.device)
    mask_high = bins[None, None, :] >= cutoff[:, None, None]
    return torch.where(mask_high, high, low)


def sample_prior(generator: Optional[torch.Generator], method: str,
                 cond: torch.Tensor, std_1: float, std_2: float,
                 cutoff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y0 for ODE integration per probability path."""
    if method not in CFM_METHODS:
        raise ValueError(f"unknown cfm_method {method}")
    eps = torch.randn(cond.shape, generator=generator, device=cond.device,
                      dtype=cond.dtype)
    if method == "basic_cfm":
        return eps
    y0 = cond * std_1 + eps * std_2
    if method == "independent_cfm_mix":
        if cutoff is None:
            raise ValueError("independent_cfm_mix needs the cutoff bins")
        return mel_replace(eps, y0, cutoff)
    return y0


def odeint_fixed(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 y0: torch.Tensor, steps: int,
                 method: str = "midpoint") -> torch.Tensor:
    """Integrate y' = f(t, y) over t in linspace(0, 1, steps + 1) (float32
    grid, as the JAX solver builds it)."""
    if method not in ("euler", "midpoint"):
        raise ValueError(f"unknown ode method {method}")
    ts = torch.linspace(0.0, 1.0, steps + 1, device=y0.device)
    y = y0
    for i in range(steps):
        t0, dt = ts[i], ts[i + 1] - ts[i]
        if method == "euler":
            y = y + dt * f(t0, y)
        else:
            k1 = f(t0, y)
            y = y + dt * f(t0 + dt * 0.5, y + dt * 0.5 * k1)
    return y
