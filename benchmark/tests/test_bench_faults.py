"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, everything else as a run does it, at a
tiny size on the CPU, once for each fault a cell can have. And the
controls, the reference one precision below the configuration's in the
program's place, fail the cells' limits (the TF32 ones only on the card,
where TF32 exists)."""

import time

import pytest
import torch

from benchmark.harness import compare, runner, spec
from benchmark.harness.drivers import field_steps
from benchmark.reference import precision
from benchmark.tests import tiny

SEED = 2**31 + 11


def _run(cell, seconds=2.0):
    code, out = runner.run(cell, SEED, seconds, False, time.perf_counter(),
                           device="cpu")
    assert code == 0
    return out


def _serving():
    return tiny.cell("serve-batch16k", pool=4, seconds=[1.0, 2.0],
                     check_clips=2, keep_every=2)


def _field():
    return tiny.cell("train-field-b128", batch=4)


def _gan():
    c = tiny.cell("gan-b16x32", batch=2)
    c.config["gan"]["segment_frames"] = 8
    return c


def test_serving_answer_altered_where_it_is_produced(monkeypatch):
    from flowhigh_tpu_torch import sr
    impl = sr.FlowHighSR._generate_impl

    def altered(self, *a, **k):
        out, n48, stats = impl(self, *a, **k)
        return out * 1.01, n48, stats
    monkeypatch.setattr(sr.FlowHighSR, "_generate_impl", altered)
    out = _run(_serving())
    assert not out["correct"], out["checks"]


def test_field_step_that_leaves_the_state_unchanged(monkeypatch):
    from flowhigh_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.Optimizer, "step", lambda self: True)
    out = _run(_field())
    assert not out["correct"], out["checks"]


def test_field_half_the_batch_left_out(monkeypatch):
    from flowhigh_tpu_torch.train import trainer
    loss = trainer.cfm_training_loss

    def half(net, x1, cond, lengths, *, draws=None, **k):
        h = x1.shape[0] // 2
        draws = type(draws)(*(t[:h] for t in draws))
        return loss(net, x1[:h], cond[:h], lengths[:h], draws=draws, **k)
    monkeypatch.setattr(trainer, "cfm_training_loss", half)
    out = _run(_field())
    assert not out["correct"], out["checks"]


def test_gan_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = _run(_gan(), seconds=0.5)
    assert not out["correct"], out["checks"]


def test_gan_half_the_batch_left_out(monkeypatch):
    from flowhigh_tpu_torch.train import vocoder_trainer
    segments = vocoder_trainer.VocoderTrainer.segments

    def half(self, batch):
        wav, mel = segments(self, batch)
        return wav[: wav.shape[0] // 2], mel[: mel.shape[0] // 2]
    monkeypatch.setattr(vocoder_trainer.VocoderTrainer, "segments", half)
    out = _run(_gan(), seconds=0.5)
    assert not out["correct"], out["checks"]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


def test_field_fp8_control_fails():
    """The configuration trains in bfloat16: the reference with fp8
    products in the program's place."""
    c = _field()
    drv = field_steps.Driver(c, SEED, "cpu")
    drv.mix = dict(drv.mix)
    ref = drv.reference(3)
    ctl = drv.reference(3, quant=precision.fp8)
    assert _fails(compare.training(ctl, ref), c.config["limits"]["train"])


@pytest.mark.cuda
def test_serving_tf32_control_fails(card):
    """At the configuration's widths, on a few clips of the mix's lengths."""
    from benchmark.harness.drivers.serve_closed import Driver
    from benchmark.harness.serving import gap
    c = spec.load_cell("serve-batch16k")
    c.traffic = dict(c.traffic, pool=4, check_clips=2, keep_every=1)
    drv = Driver(c, SEED, card)
    drv.setup()
    drv.run_window(2.0)
    reqs = drv.sample()
    drv.free()
    with precision.full_f32():
        ref = drv.reference_outputs(reqs)
    ctl = drv.reference_outputs(reqs, control=precision.tf32)
    worst = max(gap(o[0], r) for o, r in zip(ctl, ref))
    assert worst > c.config["limits"]["serve"]["wave_rel_l2"]


@pytest.mark.cuda
def test_gan_tf32_control_fails(card):
    """At the cell's own size, through the cell's own comparison."""
    from benchmark.harness.drivers import gan_steps
    c = spec.load_cell("gan-b16x32")
    drv = gan_steps.Driver(c, SEED, card)
    n = int(c.traffic["check_steps"])
    with precision.full_f32():
        ref = drv.reference(n)
    with precision.tf32():
        ctl = drv.reference(n)
    assert _fails(gan_steps.numbers(ctl, ref), c.config["limits"]["gan"])


def test_gan_rates_a_quarter_too_high(monkeypatch):
    """Both Adams at 1.25 times the configuration's rate: the generator's
    first loss already follows the discriminators' first update."""
    from flowhigh_tpu_torch.train import vocoder_trainer
    adam = vocoder_trainer.VocoderTrainer._adam

    def high(self, params):
        opt = adam(self, params)
        for group in opt.param_groups:
            group["lr"] *= 1.25
        return opt
    monkeypatch.setattr(vocoder_trainer.VocoderTrainer, "_adam", high)
    out = _run(_gan(), seconds=0.5)
    assert not out["correct"], out["checks"]
