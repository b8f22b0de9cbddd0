"""One clip through FlowHigh's super-resolution, in plain code: the
reference's ``FlowHighSR.generate`` (flowhighsr.py) with one Euler step of
the ``independent_cfm_adaptive`` path at sigma 0.

The input is zero-padded to whole seconds of output (the 1 s buckets the
served path runs), upsampled to 48 kHz, cut to the clip's true length and
peak-normalised; its log-mel is the condition and, at sigma 0, the ODE's
start; one Euler step of the vector field over [0, 1], with padded frames
masked out of attention, gives the mel that the vocoder turns into a wave,
whose low band the source's replaces (``dsp.splice``). The result is the
clip's true length at 48 kHz.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dsp, vocoder


def bucket(n: int, in_sr: int, target_sr: int = 48000) -> int:
    """Input samples after padding to whole seconds of 48 kHz output."""
    per = 48000 * in_sr // target_sr
    return max(per, math.ceil(n / per) * per)


def restore(audio: np.ndarray, in_sr: int, field, voc_weights: dict,
            cfg: dict, margin: float = 0.0) -> list:
    """audio [n] float32 at ``in_sr`` -> candidate 48 kHz results [n48]
    (float64 numpy; one, or one per cutoff the splice may take within
    ``margin``). ``field``: a ``field.VectorField`` on the device;
    ``voc_weights``: folded vocoder weights on the same device; ``cfg``: the
    configuration file."""
    device = next(field.parameters()).device
    mel, target = cfg["mel"], cfg["mel"]["sampling_rate"]
    n = len(audio)
    g = math.gcd(target, in_sr)
    up, down = target // g, in_sr // g
    n48 = (n // down) * up + (n % down) * up // down
    padded = np.zeros(bucket(n, in_sr, target), np.float64)
    padded[:n] = audio
    cond = dsp.upsample(padded, target, in_sr)
    cond[n48:] = 0.0
    cond /= max(np.abs(cond).max(), 1e-8)
    src = torch.from_numpy(cond).to(device)
    cond_mel = dsp.log_mel(src[None], mel).float()
    hop = mel["hop_length"]
    frames = cond_mel.shape[1]
    mask = (torch.arange(frames, device=device) < (n48 + hop - 1) // hop)[None]
    with torch.no_grad():
        t0 = torch.zeros(1, device=device)
        y = cond_mel + 1.0 * field(cond_mel, t0, cond_mel, mask)
        hr = vocoder.generator(y, voc_weights, cfg["vocoder"])[0]
    t_out = min(hr.shape[-1], src.shape[-1])
    hr = torch.where(torch.arange(t_out, device=device) < n48,
                     hr[:t_out].double(), 0.0)
    outs = dsp.splice(hr, src[:t_out], t_out, mel["n_fft"], hop,
                      margin=margin)
    return [o[:n48].cpu().numpy() for o in outs]
