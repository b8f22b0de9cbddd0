"""The plain reference against the program on the CPU at tiny sizes (the
program's plain PyTorch versions run there): the vector field, the
generator, the mel encoder, and whole runs of each cell's check."""

import math
import time

import pytest
import torch

from benchmark.harness import compare, runner, spec, weights
from benchmark.harness.drivers import field_steps, gan_steps
from benchmark.harness.serving import flowhigh_config
from benchmark.reference import dsp, field, vocoder
from benchmark.tests import tiny

SEED = 2**31 + 3


def _rel(a, b) -> float:
    return float((a.double() - b).norm() / b.norm())


def test_vector_field_matches_the_program():
    from flowhigh_tpu_torch.compat.torch_ckpt import \
        vector_field_state_from_reference
    from flowhigh_tpu_torch.models import VectorFieldNet
    cfg = tiny.cell("serve-batch16k").config
    sd = weights.field_weights(cfg, SEED, "cpu")
    net = VectorFieldNet(flowhigh_config(cfg).model).eval()
    net.load_state_dict(vector_field_state_from_reference(sd, net.state_dict()))
    ref = field.load_reference_state(field.VectorField(cfg["model"]), sd)
    g = torch.Generator().manual_seed(0)
    x, c = torch.randn(2, 40, 256, generator=g), torch.randn(2, 40, 256, generator=g)
    t = torch.rand(2, generator=g)
    mask = torch.arange(40)[None] < torch.tensor([[40], [31]])
    with torch.no_grad():
        want32 = ref(x, t, c, mask)
        got = net(x, times=t, cond=c, mask=mask)
        ref.double()
        want = ref(x.double(), t.double(), c.double(), mask)
    # the sharp scores (qk-norm scale 10) amplify float32 rounding: the
    # program is held to twice the float32 reference's own distance from
    # the float64 one
    assert _rel(got, want) <= 2 * _rel(want32, want) + 1e-7


def test_generator_matches_the_program():
    from flowhigh_tpu_torch.compat.torch_ckpt import vocoder_state_from_reference
    from flowhigh_tpu_torch.models import BigVGAN
    cfg = tiny.cell("serve-batch16k").config
    sd = weights.vocoder_weights(cfg, SEED, "cpu")
    voc = BigVGAN(flowhigh_config(cfg).vocoder).eval()
    voc.load_state_dict(vocoder_state_from_reference(sd, voc.state_dict()))
    mel = torch.randn(1, 12, 256, generator=torch.Generator().manual_seed(1))
    w = vocoder.fold(sd)
    with torch.no_grad():
        got = voc(mel)
        want32 = vocoder.generator(mel, w, cfg["vocoder"])
        want = vocoder.generator(mel.double(), {k: v.double() for k, v in
                                                w.items()}, cfg["vocoder"])
    assert _rel(got, want) <= 2 * _rel(want32, want) + 1e-7


def test_log_mel_matches_the_program():
    from flowhigh_tpu_torch.config import MelConfig
    from flowhigh_tpu_torch.models.melvoco import encode
    cfg = spec.load_cell("serve-batch16k").config
    wave = 0.3 * torch.randn(2, 9600, generator=torch.Generator().manual_seed(2))
    got = encode(wave, MelConfig(**cfg["mel"]))
    want = dsp.log_mel(wave, cfg["mel"])
    assert torch.allclose(got, want.float(), atol=2e-5)


@pytest.mark.parametrize("cell", ["serve-batch16k", "serve-poisson16k"])
def test_a_serving_run_is_correct(cell):
    c = tiny.cell(cell, pool=4, seconds=[1.0, 2.0], check_clips=2,
                  keep_every=2, rate=3.0)
    code, out = runner.run(c, SEED, 2.0, False, time.perf_counter(),
                           device="cpu")
    assert code == 0 and out["correct"], out["checks"]
    assert out["checks"]["clips_compared"]["value"] >= 1


def test_field_training_matches_at_float32():
    """With the program's compute dtype float32, the program's first steps
    and the reference's agree to float32 rounding."""
    c = tiny.cell("train-field-b128", batch=4)
    c.config["train"]["amp_dtype"] = "float32"
    drv = field_steps.Driver(c, SEED, "cpu")
    drv.setup()
    ref = drv.reference(3)
    got = compare.training(drv.first, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4, got


def test_gan_step_matches():
    c = tiny.cell("gan-b16x32", batch=1)
    c.config["gan"]["segment_frames"] = 8
    drv = gan_steps.Driver(c, SEED, "cpu")
    drv.setup()
    got = compare.training(drv.first, drv.reference(1))
    assert got["grad_gap"] < 1e-4 and got["loss_gap"] < 1e-5, got
    assert math.isfinite(got["change_gap"])
