"""The yardstick's arithmetic against hand-worked shapes and the program's
own parameter counts."""

import pytest
import torch

from benchmark.harness import spec
from benchmark.work import discriminators, field, peaks, vocoder

FLOWHIGH = spec.load_cell("serve-batch16k").config
GAN = spec.load_cell("gan-b16x32").config


def test_parameter_counts_match_the_program():
    from flowhigh_tpu_torch.models import BigVGAN, VectorFieldNet
    from flowhigh_tpu_torch.models.discriminators import (
        MultiPeriodDiscriminator, MultiResolutionDiscriminator)

    from benchmark.harness.serving import flowhigh_config
    cfg = flowhigh_config(FLOWHIGH)
    with torch.device("meta"):
        voc = BigVGAN(cfg.vocoder)
    assert vocoder.weights(FLOWHIGH["vocoder"]) == sum(
        p.numel() for p in voc.parameters())
    small = dict(FLOWHIGH["model"], dim=64, heads=2, dim_head=16)
    net = VectorFieldNet(flowhigh_config({**FLOWHIGH, "model": small}).model)
    assert field.weights(small) == sum(p.numel() for p in net.parameters())
    g = GAN["gan"]
    n = sum(p.numel() for m in (MultiPeriodDiscriminator(g["periods"]),
                                MultiResolutionDiscriminator(g["resolutions"]))
            for p in m.parameters())
    assert discriminators.forward(g["periods"], g["resolutions"], 4800)[
        "bytes"] == 4.0 * (4800 + n)


def test_one_stage_vocoder_by_hand():
    voc = dict(num_mels=4, upsample_initial_channel=8, upsample_rates=[2],
               upsample_kernel_sizes=[4], resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1]])
    w = vocoder.forward(voc, frames=10)
    # conv_pre 2*4*8*7*10, convT 2*8*4*4*10, one unit at T=20 on 4 channels:
    # two activations' FIRs 2*48*4*20 and two k=3 convs 2*2*4*4*3*20,
    # activation_post's FIRs 48*4*20, conv_post 2*4*7*20
    assert w["dots"] == (4480 + 2560 + 7680 + 3840 + 3840 + 1120)
    # snakes 10 a channel-sample: 3 activations on 4 x 20; conv outputs: bias
    # and residual on 4 x 20 a unit conv, the blocks' mean, the upsampler's
    # bias, conv_pre's bias and residual, tanh and conv_post's bias
    assert w["other"] == (3 * 10 * 80 + 3 * 80 + 80 + 80 + 2 * 8 * 10 + 2 * 20)
    assert w["bytes"] == 4.0 * (10 * 4 + 20 + vocoder.weights(voc))


def test_field_dots_by_hand():
    m = dict(FLOWHIGH["model"])
    d, din, h = m["dim"], m["dim_in"], m["heads"] * m["dim_head"]
    inner = int(d * m["ff_mult"] * 2 / 3)
    per_frame = 2 * (2 * din * d + 31 * d + d * din) + m["depth"] * 2 * (
        3 * d * h + h * d + d * 2 * inner + inner * d)
    quad = m["depth"] * 2 * 2 * h  # scores and weighted sum, a frame pair
    for n in (100, 200):
        assert field.forward(m, n)["dots"] == per_frame * n + quad * n * n


def test_bound_takes_the_larger_of_compute_and_bytes():
    p = peaks.PEAKS
    assert peaks.bound_s({"dots": 495e12, "other": 0.0, "bytes": 0.0}, p) == 1.0
    assert peaks.bound_s({"dots": 0.0, "other": 0.0, "bytes": 3.35e12}, p) == 1.0
    assert peaks.bound_s({"dots": 989e12, "other": 0.0, "bytes": 0.0}, p,
                         "bfloat16") == 1.0
