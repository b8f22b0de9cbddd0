"""Conditional flow matching at inference: cutoff search, prior, fixed-grid
and adaptive ODE solvers — counterpart of the sampling half of
``flowhigh_tpu/cfm.py``.

The cutoff-frequency search is a cumsum + comparison count (no host sync),
and the euler/midpoint solvers match ``torchdiffeq.odeint`` on
``linspace(0, 1, steps + 1)`` and read nothing back from the device. The
adaptive solver (``odeint_adaptive``, dopri5 or tsit5 with per-item step
control) has to read its loop condition back once per loop. Noise comes
from an explicit ``torch.Generator`` (or from the caller's ``eps``); with
the reference's executed prior (``std_2 = sigma = 0``) the prior is
``cond`` itself and no random number reaches the output.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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
                 cutoff: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y0 for ODE integration per probability path. ``eps`` (shaped like
    ``cond``) replaces the standard normal draw from ``generator``: JAX's
    draws cannot be reproduced in torch, so a caller that must match the
    JAX package passes its draw here."""
    if method not in CFM_METHODS:
        raise ValueError(f"unknown cfm_method {method}")
    if eps is None:
        eps = torch.randn(cond.shape, generator=generator, device=cond.device,
                          dtype=cond.dtype)
    else:
        eps = torch.as_tensor(eps, dtype=cond.dtype, device=cond.device)
        if eps.shape != cond.shape:
            raise ValueError(f"eps shape {tuple(eps.shape)} differs from "
                             f"cond's {tuple(cond.shape)}")
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


class AdaptiveStats(NamedTuple):
    converged: torch.Tensor   # [B] bool: the item reached t = 1 in max_steps
    n_accepted: torch.Tensor  # [B] int32: the item's accepted steps
    n_loops: torch.Tensor     # [] int32: solver loops (7 field calls each)


# 7-stage 5(4) embedded pairs: (c, a, b5, b4) per tableau, the JAX
# package's literals. dopri5 = Dormand-Prince (scipy's RK45); tsit5 =
# Tsitouras 2011, the solver the reference's torchode path instantiates.
_DOPRI5_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_DOPRI5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI5_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DOPRI5_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
              187 / 2100, 1 / 40]

_TSIT5_C = [0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0]
_TSIT5_A = [
    [],
    [0.161],
    [-0.008480655492356989, 0.335480655492357],
    [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
    [5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525],
    [5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383],
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774],
]
_TSIT5_B5 = _TSIT5_A[6] + [0.0]  # FSAL: the 5th-order weights = last a row
# the embedded 4th order from the published btilde (= b5 - b4)
_TSIT5_BTILDE = [-0.00178001105222577714, -0.0008164344596567469,
                 0.007880878010261995, -0.1447110071732629,
                 0.5823571654525552, -0.45808210592918697,
                 0.015151515151515152]
_TSIT5_B4 = [b - e for b, e in zip(_TSIT5_B5, _TSIT5_BTILDE)]

TABLEAUS = {
    "dopri5": (_DOPRI5_C, _DOPRI5_A, _DOPRI5_B5, _DOPRI5_B4),
    "tsit5": (_TSIT5_C, _TSIT5_A, _TSIT5_B5, _TSIT5_B4),
}


def odeint_adaptive(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    y0: torch.Tensor, atol: float = 1e-5, rtol: float = 1e-5,
                    max_steps: int = 256, return_stats: bool = False,
                    tableau: str = "dopri5"):
    """Adaptive embedded RK 5(4) over t in [0, 1] with per-item step
    control, as the JAX package's ``odeint_adaptive``: each batch item
    carries its own t, h and error history, so an easy item never takes a
    stiff neighbour's step size. ``f(t, y)`` receives ``t`` of shape [B].
    Accepted steps use the PI controller ``0.9 err^(-0.7/5)
    err_prev^(0.4/5)``, rejected ones I-control capped at 1, both clipped
    to [0.2, 5]; h starts at 0.05. Items that have reached t = 1 stay
    frozen (a zero step, never accepted) while the others go on. Items that
    hit ``max_steps`` loops first are reported in ``AdaptiveStats``
    (``return_stats=True``).

    The JAX solver is a ``lax.while_loop`` whose condition stays on the
    device. Here the condition ``any(t < 1)`` is read back to the host once
    per loop, after its 7 field calls, so a caller of the adaptive solver
    waits on the device once per loop; the fixed-grid solver reads nothing
    back."""
    if tableau not in TABLEAUS:
        raise ValueError(f"unknown tableau {tableau!r} "
                         f"(options: {sorted(TABLEAUS)})")
    c, a, b5, b4 = TABLEAUS[tableau]
    b = y0.shape[0]
    bshape = (b,) + (1,) * (y0.ndim - 1)
    dims = tuple(range(1, y0.ndim))
    like = dict(device=y0.device, dtype=torch.float32)

    def rk_step(t, y, h):
        hb = h.reshape(bshape)
        ks = []
        for i in range(7):
            yi = y
            for j, aij in enumerate(a[i]):
                yi = yi + hb * aij * ks[j]
            ks.append(f(t + c[i] * h, yi))
        y5, y4 = y, y
        for i in range(7):
            y5 = y5 + hb * b5[i] * ks[i]
            y4 = y4 + hb * b4[i] * ks[i]
        return y5, y5 - y4

    t = torch.zeros(b, **like)
    h = torch.full((b,), 0.05, **like)
    err_prev = torch.ones(b, **like)
    nacc = torch.zeros(b, device=y0.device, dtype=torch.int32)
    zero = torch.zeros((), **like)
    y, n = y0, 0
    # every t is 0 before the first loop: the condition is read after each
    while n < max_steps and (n == 0 or bool(torch.any(t < 1.0))):
        active = t < 1.0
        h_eff = torch.where(active, torch.minimum(h, 1.0 - t), zero)
        y5, err = rk_step(t, y, h_eff)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        sq = torch.square(err / scale)
        err_norm = torch.sqrt(sq.mean(dim=dims) if dims else sq)
        err_norm = torch.clamp(err_norm, min=1e-10)
        accept = (err_norm <= 1.0) & active
        factor_pi = 0.9 * err_norm ** (-0.7 / 5) * err_prev ** (0.4 / 5)
        factor_i = torch.clamp(0.9 * err_norm ** (-1 / 5), max=1.0)
        factor = torch.clamp(torch.where(accept, factor_pi, factor_i),
                             0.2, 5.0)
        t = torch.where(accept, t + h_eff, t)
        y = torch.where(accept.reshape(bshape), y5, y)
        h = torch.where(active, h_eff * factor, h)
        err_prev = torch.where(accept, err_norm, err_prev)
        nacc = nacc + accept.to(torch.int32)
        n += 1
    if return_stats:
        return y, AdaptiveStats(
            converged=t >= 1.0, n_accepted=nacc,
            n_loops=torch.tensor(n, dtype=torch.int32, device=y0.device))
    return y
