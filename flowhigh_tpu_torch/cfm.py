"""Conditional flow matching: cutoff search, prior, fixed-grid and
adaptive ODE solvers, and the training loss — counterpart of
``flowhigh_tpu/cfm.py``.

The cutoff-frequency search is a cumsum + comparison count (no host sync),
and the euler/midpoint solvers match ``torchdiffeq.odeint`` on
``linspace(0, 1, steps + 1)`` and read nothing back from the device. The
adaptive solver (``odeint_adaptive``, dopri5 or tsit5 with per-item step
control) has to read its loop condition back once per loop. Noise comes
from an explicit ``torch.Generator`` (or from the caller's ``eps``); with
the reference's executed prior (``std_2 = sigma = 0``) the prior is
``cond`` itself and no random number reaches the output.

Training: ``sample_path`` builds (x_t, u_t) for the four probability
paths, ``crop_segments`` cuts the 2 s segments, ``freq_mask_cond`` masks
a band of the condition, ``cfm_loss`` is the (masked, cutoff-weighted)
MSE and ``cfm_training_loss`` puts them together. JAX's draws cannot be
made in torch, so every random number of a training loss is an explicit
``TrainingDraws``, drawn from a caller's generator (``draw_training``) or
passed in (the tests pass JAX's own).
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


# --- training ------------------------------------------------------------------

class PathSample(NamedTuple):
    x_t: torch.Tensor                # the noisy state fed to the network
    u_t: torch.Tensor                # the target vector field
    cutoff: Optional[torch.Tensor]   # [B] cutoff bins (mix path only)


def sample_path(method: str, x1: torch.Tensor, cond: torch.Tensor,
                t: torch.Tensor, sigma_min: float,
                eps: torch.Tensor) -> PathSample:
    """(x_t, u_t) of one of the four CFM probability paths for targets
    ``x1`` [B, T, M], conditions ``cond`` (the x0 of the independent
    paths), times ``t`` [B] and the standard normal draw ``eps`` (shaped
    like ``x1``)."""
    if method not in CFM_METHODS:
        raise ValueError(f"unknown cfm_method {method}")
    tb = t[:, None, None]
    if method == "basic_cfm":  # x0 ~ N(0, I)
        x_t = (1 - (1 - sigma_min) * tb) * eps + tb * x1
        return PathSample(x_t, x1 - (1 - sigma_min) * eps, None)
    x0 = cond
    if method == "independent_cfm_adaptive":
        x_t = tb * x1 + (1 - tb) * x0 + (1 - (1 - sigma_min) * tb) * eps
        return PathSample(x_t, (x1 - x0) - (1 - sigma_min) * eps, None)
    if method == "independent_cfm_constant":
        x_t = tb * x1 + (1 - tb) * x0 + sigma_min * eps
        return PathSample(x_t, x1 - x0, None)
    # independent_cfm_mix: the high band on the basic path, the low band on
    # the independent one
    cutoff = mel_cutoff_bins(cond)
    x_t_high = tb * x1 + (1 - (1 - sigma_min) * tb) * eps
    x_t_low = tb * x1 + (1 - tb) * x0 + sigma_min * eps
    u_high = x1 - (1 - sigma_min) * eps
    u_low = x1 - x0
    return PathSample(mel_replace(x_t_high, x_t_low, cutoff),
                      mel_replace(u_high, u_low, cutoff), cutoff)


def cfm_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None, weighted: bool = False,
             cutoff: Optional[torch.Tensor] = None, low_weight: float = 1.0,
             high_weight: float = 2.0) -> torch.Tensor:
    """MSE of [B, T, M] ``pred`` against ``target``: over every element,
    or, with ``mask`` [B, T] (True = valid), per item over its valid frames
    (the frame count clipped at 1e-5) and then over the batch. ``weighted``
    weighs bins >= ``cutoff`` [B] by ``high_weight``, the rest by
    ``low_weight``; it needs the cutoff (the mix path's)."""
    se = torch.square(pred - target)
    if weighted:
        if cutoff is None:
            raise ValueError("weighted cfm_loss needs the cutoff bins (the "
                             "independent_cfm_mix path's)")
        bins = torch.arange(pred.shape[-1], device=pred.device)
        w = torch.where(bins[None, :] >= cutoff[:, None], high_weight,
                        low_weight).to(se.dtype)
        se = se * w[:, None, :]
    if mask is None:
        return torch.mean(se)
    per_frame = torch.where(mask, torch.mean(se, dim=-1), 0.0)
    den = torch.clamp(mask.to(per_frame.dtype).sum(dim=-1), min=1e-5)
    return torch.mean(per_frame.sum(dim=-1) / den)


def freq_mask_cond(cond: torch.Tensor, height: torch.Tensor,
                   start: torch.Tensor) -> torch.Tensor:
    """Each item's bins [start, start + height) of ``cond`` [B, T, M] set
    to min(cond) + 1e-3 (the minimum over the whole batch); ``height``,
    ``start`` [B] int (``draw_training``: heights in [10, 20], starts in
    [20, M - 21])."""
    bins = torch.arange(cond.shape[-1], device=cond.device)
    in_band = ((bins[None, :] >= start[:, None])
               & (bins[None, :] < (start + height)[:, None]))
    return torch.where(in_band[:, None, :], torch.min(cond) + 1e-3, cond)


def crop_segments(arrays, lengths: torch.Tensor, out_size: int,
                  u: torch.Tensor):
    """``out_size``-frame crops of each [B, T, M] array at offset
    int(u * max(length - out_size, 0)) per item (``u`` [B] uniform in
    [0, 1)), zero past the item's valid length; arrays shorter than
    ``out_size`` are zero-padded first. Returns (the crops, the crop mask
    [B, out_size]: frame < min(length, out_size))."""
    b, t_full = arrays[0].shape[:2]
    max_offset = torch.clamp(lengths - out_size, min=0)
    offsets = (u * max_offset.to(u.dtype)).to(torch.int64)
    # a slice that would run past the end starts earlier, as
    # lax.dynamic_slice clamps it
    offsets = torch.clamp(offsets, max=max(t_full, out_size) - out_size)
    cut = torch.minimum(lengths, torch.full_like(lengths, out_size))
    frames = torch.arange(out_size, device=lengths.device)
    mask = frames[None, :] < cut[:, None]
    idx = (offsets[:, None] + frames[None, :])[..., None]
    outs = []
    for a in arrays:
        if t_full < out_size:
            a = torch.nn.functional.pad(a, (0, 0, 0, out_size - t_full))
        cropped = torch.gather(a, 1, idx.expand(-1, -1, a.shape[-1]))
        outs.append(torch.where(mask[..., None], cropped, 0.0))
    return tuple(outs), mask


class TrainingDraws(NamedTuple):
    """Every random number of one ``cfm_training_loss`` call but the
    dropout masks, in the JAX function's order of keys (r_t, r_path,
    r_crop, r_drop, r_fm): ``t`` [B] flow times, ``eps`` [B, T, M] the
    path's normal draw, ``crop_u`` [B] the crop offsets' uniforms,
    ``drop_u`` [B] the condition drop's uniforms, ``fm_height`` and
    ``fm_start`` [B] the frequency mask's band."""
    t: torch.Tensor
    eps: torch.Tensor
    crop_u: torch.Tensor
    drop_u: torch.Tensor
    fm_height: torch.Tensor
    fm_start: torch.Tensor


def draw_training(generator: Optional[torch.Generator], shape,
                  device) -> TrainingDraws:
    """``TrainingDraws`` for mels of ``shape`` (B, T, M) from
    ``generator`` (torch's default generator when None), on ``device``.
    Everything is drawn whatever the loss's options, so a run's draws
    do not depend on them."""
    b, _, m = shape
    kw = dict(generator=generator, device=device)
    return TrainingDraws(
        t=torch.rand(b, **kw), eps=torch.randn(tuple(shape), **kw),
        crop_u=torch.rand(b, **kw), drop_u=torch.rand(b, **kw),
        fm_height=torch.randint(10, 21, (b,), **kw),
        fm_start=torch.randint(20, max(m - 20, 21), (b,), **kw))


def cfm_training_loss(net, x1_mel: torch.Tensor, cond_mel: torch.Tensor,
                      mel_lengths: torch.Tensor, *, method: str,
                      sigma: float, out_size: int,
                      cond_drop_prob: float = 0.0, weighted: bool = False,
                      cond_freq_masking: bool = False, train: bool = True,
                      draws: Optional[TrainingDraws] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Path construction, segment crop and the vector field's regression
    loss for targets ``x1_mel`` and conditions ``cond_mel`` [B, T, M] with
    ``mel_lengths`` [B] valid frames; ``out_size`` <= 0 keeps whole
    sequences. ``net`` (a ``VectorFieldNet``) runs in train mode (dropout
    on) with ``train``, in eval mode without; its mode comes back after.
    ``draws`` are the loss's random numbers (``draw_training`` from
    ``generator`` when None); the dropout masks come from ``generator``
    after them."""
    if draws is None:
        draws = draw_training(generator, x1_mel.shape, x1_mel.device)
    if cond_freq_masking:
        cond_mel = freq_mask_cond(cond_mel, draws.fm_height, draws.fm_start)
    t = draws.t
    ps = sample_path(method, x1_mel, cond_mel, t, sigma, draws.eps)
    if out_size and out_size > 0:
        (w, flow, cond_c), mask = crop_segments(
            (ps.x_t, ps.u_t, cond_mel), mel_lengths, out_size, draws.crop_u)
    else:
        w, flow, cond_c = ps.x_t, ps.u_t, cond_mel
        frames = torch.arange(x1_mel.shape[1], device=x1_mel.device)
        mask = frames[None, :] < mel_lengths[:, None]
    drop_mask = draws.drop_u < cond_drop_prob if cond_drop_prob > 0 else None
    was_training = net.training
    net.train(train)
    try:
        pred = net(w, times=t, cond=cond_c, cond_drop_mask=drop_mask,
                   mask=mask, generator=generator)
    finally:
        net.train(was_training)
    return cfm_loss(pred, flow, mask=mask, weighted=weighted,
                    cutoff=ps.cutoff)
