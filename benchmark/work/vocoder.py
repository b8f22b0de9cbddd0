"""BigVGAN's generator: the work of one forward over ``frames`` mel frames
of a batch of ``batch`` (the configuration's ``vocoder`` group).

Dots are the multiply-adds, 2 operations each: convs 2 Cin Cout K T,
transposed convs 2 Cin Cout K T_in, and an activation's two 12-tap FIRs
(the 2x upsample: 6 taps an output at twice the rate; the downsample: 12
taps an output), 48 C T. Other operations: the snake's five a sample at
twice the rate (multiply, sine, square, scale, add), a bias and a residual
add a conv output, the blocks' mean, tanh. Bytes: the mel in, the wave
out, the float32 weights, once."""

from __future__ import annotations

import numpy as np

SNAKE_OTHER = 10.0  # per channel-sample: five operations at twice the rate
FIR_DOTS = 48.0     # per channel-sample: 24 multiply-adds


def weights(voc: dict) -> int:
    """Parameters of the generator."""
    ch = voc["upsample_initial_channel"]
    n = ch * voc["num_mels"] * 7 + ch
    nk = len(voc["resblock_kernel_sizes"])
    for i, k in enumerate(voc["upsample_kernel_sizes"]):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        n += cin * cout * k + cout
        for rk, rd in zip(voc["resblock_kernel_sizes"],
                          voc["resblock_dilation_sizes"]):
            n += len(rd) * (2 * (cout * cout * rk + cout) + 4 * cout)
    return n + 2 * cout + cout * 7 + 1


def forward(voc: dict, frames: int, batch: int = 1,
            library: bool = True) -> dict:
    """``library=False`` leaves out conv_pre and tanh (the work of the
    port's kernels A, B and C alone)."""
    ch, t = voc["upsample_initial_channel"], frames
    dots = 2.0 * voc["num_mels"] * ch * 7 * t if library else 0.0
    other = 2.0 * ch * t if library else 0.0
    nk = len(voc["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        cout = ch // 2 ** (i + 1)
        dots += 2.0 * (ch // 2 ** i) * cout * k * t
        t *= u
        other += cout * t
        for rk, rd in zip(voc["resblock_kernel_sizes"],
                          voc["resblock_dilation_sizes"]):
            units = len(rd)
            dots += units * (2 * FIR_DOTS * cout * t + 2 * 2.0 * cout * cout
                             * rk * t)
            other += units * (2 * SNAKE_OTHER * cout * t + 3.0 * cout * t)
        other += nk * cout * t  # the mean of the blocks
    dots += FIR_DOTS * cout * t + 2.0 * cout * 7 * t
    other += SNAKE_OTHER * cout * t + (2.0 if library else 1.0) * t
    byt = 4.0 * (frames * voc["num_mels"] + t + weights(voc) / batch)
    return {"dots": batch * dots, "other": batch * other,
            "bytes": batch * byt}


def output_samples(voc: dict, frames: int) -> int:
    return frames * int(np.prod(voc["upsample_rates"]))
