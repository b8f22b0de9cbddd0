"""The port's reference-kwarg wrapper (``flowhigh_tpu_torch.cfm_wrapper``),
utility helpers (``utils``) and metrics against the JAX package's on the
CPU, mirroring tests/test_api_compat.py; the training loss (``forward``,
ROADMAP.md queue 1 item 12(a)) on audio here, on each path in
tests/test_torch_train_loss.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import ConditionalFlowMatcherWrapper as JaxWrapper
from flowhigh_tpu import FLowHigh as JaxFLowHigh
from flowhigh_tpu import init_bigvgan as jax_init_bigvgan
from flowhigh_tpu import metrics as jm
from flowhigh_tpu import utils as ju
from flowhigh_tpu.compat import params_to_torch_state
from flowhigh_tpu.compat.torch_ckpt import vocoder_params_to_torch_state
from flowhigh_tpu.config import MelConfig as JaxMelConfig
from flowhigh_tpu.config import VocoderConfig as JaxVocoderConfig
from flowhigh_tpu.models import MelVoco as JaxMelVoco
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import ConditionalFlowMatcherWrapper, FLowHigh
from flowhigh_tpu_torch import init_bigvgan, metrics
from flowhigh_tpu_torch import utils as pu
from flowhigh_tpu_torch.compat import (vector_field_state_from_jax,
                                       vocoder_state_from_jax)
from flowhigh_tpu_torch.config import MelConfig, VocoderConfig
from flowhigh_tpu_torch.models import MelVoco
from test_torch_sample import _jax_draw
from test_torch_sr import _perturbed_1d
from test_torch_train_loss import jax_draws
from test_torch_vector_options import _field_params

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# tests/test_api_compat.py's wrapper
VOCODER = dict(num_mels=256, upsample_initial_channel=16,
               upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
FIELD = dict(dim_in=256, dim=32, depth=2, dim_head=8, heads=2)
WRAP = dict(sigma=1e-4, cfm_method="independent_cfm_adaptive",
            torchdiffeq_ode_method="euler")


@pytest.fixture(scope="module")
def wrappers():
    """The JAX wrapper and the port's, on the same weights: the field and
    vocoder params without compiling their inits (``_fast_init``)."""
    jvoc = JaxMelVoco(JaxMelConfig(), JaxVocoderConfig(**VOCODER))
    jvoc.vocoder_params = _perturbed_1d(_fast_init(
        lambda r: jvoc.vocoder.init(r, jnp.zeros((1, 4, 256))),
        jax.random.PRNGKey(1)), 2, 0.1)
    jfh = JaxFLowHigh(audio_enc_dec=jvoc, **FIELD)
    jfh.params = _field_params(jfh.net, 0)
    pvoc = MelVoco(MelConfig(), VocoderConfig(**VOCODER),
                   vocoder_params=jvoc.vocoder_params, device="cpu")
    pfh = FLowHigh(audio_enc_dec=pvoc, params=jfh.params, device="cpu",
                   **FIELD)
    return JaxWrapper(jfh, **WRAP), ConditionalFlowMatcherWrapper(pfh, **WRAP)


def _mel(rng, frames=30):  # a log-mel in the codec's range
    return (rng.standard_normal((1, frames, 256)) - 4.0).astype(np.float32)


# --- the wrapper ------------------------------------------------------------------

# cond_scale 2, mel_pp and a frame mask on the second case
MEL_CASES = {"plain": {}, "cfg2_pp_mask": dict(
    cond_scale=2.0, mel_pp=True, cond_mask=np.arange(30)[None, :] < 23)}


@pytest.mark.parametrize("case", MEL_CASES)
def test_sample_from_mel(wrappers, rng, case):
    jw, pw = wrappers
    kw = MEL_CASES[case]
    cond = _mel(rng)
    want = np.asarray(jw.sample(
        cond=jnp.asarray(cond), time_steps=2, decode_to_audio=False,
        **{k: jnp.asarray(v) if k == "cond_mask" else v
           for k, v in kw.items()}))
    got = pw.sample(cond=cond, time_steps=2, decode_to_audio=False,
                    eps=_jax_draw(0, cond.shape), **kw).numpy()
    assert got.shape == want.shape == (1, 30, 256)
    # tests/test_torch_sample.py's bound (the generate bound)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_from_raw_audio_decodes(wrappers, rng):
    jw, pw = wrappers
    cond = (rng.standard_normal((1, 9600)) * 0.3).astype(np.float32)
    want = np.asarray(jw.sample(cond=jnp.asarray(cond), time_steps=1))
    got = pw.sample(cond=cond, time_steps=1,
                    eps=_jax_draw(0, (1, 9600 // 480, 256))).numpy()
    assert got.shape == want.shape and got.shape[1] > 8000
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_adaptive_with_mel_pp(wrappers, rng):
    # use_torchode: the adaptive solver with the tsit5 tableau
    jw, pw = wrappers
    jwa = JaxWrapper(jw.flowhigh, use_torchode=True, **WRAP)
    pwa = ConditionalFlowMatcherWrapper(pw.flowhigh, use_torchode=True, **WRAP)
    assert jwa.ode_tableau == pwa.ode_tableau == "tsit5"
    cond = _mel(rng, 20)
    want = np.asarray(jwa.sample(cond=jnp.asarray(cond), mel_pp=True,
                                 decode_to_audio=False))
    got = pwa.sample(cond=cond, mel_pp=True, decode_to_audio=False,
                     eps=_jax_draw(0, cond.shape)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_needs_a_codec_for_audio(wrappers, rng):
    _, pw = wrappers
    bare = ConditionalFlowMatcherWrapper(FLowHigh(device="cpu", **FIELD))
    with pytest.raises(ValueError, match="audio_enc_dec"):
        bare.sample(cond=np.zeros((1, 4800), np.float32))
    # without a codec a mel condition samples a mel
    out = bare.sample(cond=_mel(rng, 8), time_steps=1)
    assert tuple(out.shape) == (1, 8, 256)
    a = pw.sample(cond=_mel(rng, 8), time_steps=1, decode_to_audio=False,
                  generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(a).all()


def test_forward_is_item_12a(wrappers, rng):
    """Item 12(a) ported: the training loss on 0.5 s of audio (shorter than
    the 2 s crop), through ``forward`` and the call, equals the JAX
    wrapper's on JAX's draws."""
    jw, pw = wrappers
    x1 = (rng.standard_normal((2, 24000)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = float(jax.jit(lambda a, r: jw.forward(a, cond=0.5 * a, rng=r))(
        x1, key))
    draws = jax_draws(key, (2, 50, 256))  # 50 frames of 0.5 s
    for call in (pw.forward, pw):
        got = float(call(x1, cond=0.5 * x1, draws=draws).detach())
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_load_reference_layout(wrappers, tmp_path):
    jw, _ = wrappers
    sd = params_to_torch_state(jw.flowhigh.params, jw.flowhigh.config)
    pkg = {"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
           "optim": {}, "scheduler": {}}
    torch.save(pkg, tmp_path / "ckpt.pt")
    fresh = ConditionalFlowMatcherWrapper(FLowHigh(device="cpu", **FIELD))
    fresh.flowhigh.init_params(9)
    assert set(fresh.load(tmp_path / "ckpt.pt")) == {"model", "optim",
                                                     "scheduler"}
    want = vector_field_state_from_jax(jw.flowhigh.params,
                                       fresh.flowhigh.config)
    for k, v in fresh.flowhigh.net.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-7)
    x = np.random.default_rng(1).standard_normal((1, 6, 256)).astype(
        np.float32)
    np.testing.assert_allclose(  # FLowHigh's call: the field itself
        fresh.flowhigh(torch.from_numpy(x), times=torch.tensor(0.3),
                       cond=torch.from_numpy(x)).numpy(),
        np.asarray(jw.flowhigh(jnp.asarray(x), times=jnp.asarray(0.3),
                               cond=jnp.asarray(x))), atol=1e-4, rtol=1e-4)
    with pytest.raises(FileNotFoundError):
        fresh.load(tmp_path / "missing.pt")


def test_init_bigvgan_matches_jax(wrappers, tmp_path):
    jw, _ = wrappers
    params = jw.flowhigh.audio_enc_dec.vocoder_params
    torch.save({"generator": vocoder_params_to_torch_state(
        params, JaxVocoderConfig(**VOCODER))}, tmp_path / "g.pt")
    (tmp_path / "g.json").write_text(json.dumps(
        {**VOCODER, "resblock_dilation_sizes": [[1, 3]], "resblock": "1",
         "activation": "snakebeta", "snake_logscale": True}))
    jcfg, jparams = jax_init_bigvgan(tmp_path / "g.json", tmp_path / "g.pt")
    cfg, voc = init_bigvgan(tmp_path / "g.json", tmp_path / "g.pt",
                            device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not voc.training and not any(p.requires_grad
                                        for p in voc.parameters())
    want = vocoder_state_from_jax(jax.device_get(jparams), cfg)
    for k, v in voc.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6)
    _, trainable = init_bigvgan(tmp_path / "g.json", tmp_path / "g.pt",
                                vocoder_freeze=False, device="cpu")
    assert all(p.requires_grad for p in trainable.parameters())


def test_init_bigvgan_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``device`` the generator goes to the card; with no card it
    refuses rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_bigvgan(tmp_path / "g.json", tmp_path / "g.pt")


def test_constructor_surface_matches_jax():
    kw = dict(dim_in=8, dim=16, depth=2, dim_head=4, heads=2, dim_cond_emb=0,
              ff_dropout=0.1, attn_dropout=0.2, time_hidden_dim=None,
              conv_pos_embed_groups=None, attn_flash=True,
              use_gateloop_layers=True, num_register_tokens=2,
              use_unet_skip_connection=True, skip_connect_scale=0.5)
    port = FLowHigh(device="cpu", **kw)
    assert (dataclasses.asdict(port.config)
            == dataclasses.asdict(JaxFLowHigh(**kw).config))
    assert port.net.transformer.layers[1][0].weight.shape == (16, 32)
    for bad in (dict(dim_cond_emb=4), dict(time_hidden_dim=99),
                dict(conv_pos_embed_groups=5)):
        with pytest.raises(NotImplementedError):
            FLowHigh(dim_in=8, dim=16, depth=2, device="cpu", **bad)
        with pytest.raises(NotImplementedError):
            JaxFLowHigh(dim_in=8, dim=16, depth=2, **bad)
    assert FLowHigh(dim=16, depth=2, device="cpu").config.dim_in == 16


# --- utils ------------------------------------------------------------------------

def test_small_helpers():
    assert pu.exists(0) and not pu.exists(None)
    assert pu.default(None, 3) == 3 and pu.default(2, 3) == 2
    assert pu.divisible_by(6, 3) and pu.is_odd(5) and not pu.is_odd(4)
    got = pu.sequence_mask(torch.tensor([2, 4]), 5)
    assert got.tolist() == np.asarray(
        ju.sequence_mask(jnp.array([2, 4]), 5)).tolist()
    assert pu.sequence_mask(torch.tensor([1, 3])).shape == (2, 3)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("length", [25, 7])
def test_interpolate_1d_matches_jax(rng, mode, length):
    x = rng.standard_normal((2, 3, 10)).astype(np.float32)
    want = np.asarray(ju.interpolate_1d(jnp.asarray(x), length, mode))
    got = pu.interpolate_1d(torch.from_numpy(x), length, mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    got2 = pu.interpolate_1d(torch.from_numpy(x[:, 0]), length, mode).numpy()
    np.testing.assert_allclose(got2, want[:, 0], atol=1e-6)
    with pytest.raises(ValueError):
        pu.interpolate_1d(torch.from_numpy(x), length, "cubic")


def test_curtail_or_pad_matches_jax(rng):
    x = rng.standard_normal((1, 5, 3)).astype(np.float32)
    for n in (3, 5, 8):
        want = np.asarray(ju.curtail_or_pad(jnp.asarray(x), n))
        got = pu.curtail_or_pad(torch.from_numpy(x), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_masks_match_jax():
    m = pu.mask_from_start_end_indices(6, torch.tensor([1]), torch.tensor([4]))
    assert m.tolist() == [[False, True, True, True, False, False]]
    frac = np.array([0.5, 0.3, 0.9], np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(ju.mask_from_frac_lengths(key, 10, jnp.asarray(frac)))
    # the JAX function's uniform draw, handed to the port
    draw = np.array(jax.random.uniform(key, frac.shape))
    got = pu.mask_from_frac_lengths(10, torch.from_numpy(frac),
                                    uniform=torch.from_numpy(draw))
    assert got.tolist() == want.tolist()
    drawn = pu.mask_from_frac_lengths(
        10, torch.from_numpy(frac), generator=torch.Generator().manual_seed(0))
    assert drawn.sum(dim=1).tolist() == [5, 3, 9]


def test_log_helpers_match_jax(rng):
    x = rng.standard_normal(100).astype(np.float32) * 10
    pos = np.abs(x) + np.float32(1e-9)
    for pf, jf, arg in ((pu.symlog, ju.symlog, x), (pu.symexp, ju.symexp, x / 4),
                        (pu.safe_log, ju.safe_log, pos),
                        (pu.dynamic_range_compression,
                         ju.dynamic_range_compression, pos),
                        (pu.dynamic_range_decompression,
                         ju.dynamic_range_decompression, x / 4)):
        np.testing.assert_allclose(pf(torch.from_numpy(arg)).numpy(),
                                   np.asarray(jf(jnp.asarray(arg))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pu.symexp(pu.symlog(torch.from_numpy(x))).numpy(), x, rtol=1e-4,
        atol=1e-4)


def test_stftmag_matches_jax(rng):
    x = rng.standard_normal(4800).astype(np.float32)
    want = np.asarray(ju.STFTMag()(jnp.asarray(x)))
    got = pu.STFTMag()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[1] == 1025
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_model_summary_counts_as_jax(wrappers):
    jw, pw = wrappers
    total = int(ju.model_summary(jw.flowhigh.params).splitlines()[-1]
                .split()[1].replace(",", ""))
    text = pu.model_summary(pw.flowhigh.net, "field")
    assert text.splitlines()[0] == "field parameter summary"
    assert int(text.splitlines()[-1].split()[1].replace(",", "")) == total
    assert "transformer.layers" in text
    sd_text = pu.model_summary(pw.flowhigh.net.state_dict())
    assert sd_text.splitlines()[-1] == text.splitlines()[-1]


def test_mel_bin_helpers_match_jax():
    for f in (0.0, 700.0, 8000.0, [1000.0, 4000.0], np.array([10.0, 2e4])):
        np.testing.assert_allclose(pu.hz_to_mel_htk(f), ju.hz_to_mel_htk(f),
                                   rtol=1e-12)
    for f in (0, 8000, 24000, np.array([1000.0, 4000.0])):
        got, want = pu.mel_bin_index(f, 48000, 256), ju.mel_bin_index(
            f, 48000, 256)
        assert np.array_equal(got, want) and type(got) is type(want)


# --- metrics ----------------------------------------------------------------------

def test_metrics_match_jax(rng):
    ref = rng.standard_normal((2, 24000)).astype(np.float32) * 0.3
    est = ref + rng.standard_normal((2, 24000)).astype(np.float32) * 0.05
    for name in ("high_band_lsd", "snr_db"):
        want = np.asarray(getattr(jm, name)(jnp.asarray(ref),
                                            jnp.asarray(est)))
        got = getattr(metrics, name)(torch.from_numpy(ref),
                                     torch.from_numpy(est)).numpy()
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the JAX function traces cutoff_hz and sr, so only its defaults run;
    # with the cutoff at 0 Hz the high band is the whole band
    np.testing.assert_allclose(
        metrics.high_band_lsd(ref, est, cutoff_hz=0.0).numpy(),
        metrics.log_spectral_distance(ref, est).numpy(), rtol=1e-6)
    a, b = _mel(rng, 12), _mel(rng, 12)
    np.testing.assert_allclose(float(metrics.mel_l1(a, b)),
                               float(jm.mel_l1(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def test_rtf_timer_synchronises_before_each_clock_read(monkeypatch):
    events = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: events.append("sync"))
    monkeypatch.setattr(metrics.time, "perf_counter",
                        lambda: events.append("clock") or len(events) * 0.5)
    timer = metrics.RTFTimer(audio_seconds=10.0)
    rtf = timer.measure(lambda: events.append("call"), reps=3, warmup=1)
    assert events[:2] == ["call", "sync"]  # the warm-up
    for i in range(3):  # each rep: sync, clock, call, sync, clock
        assert events[2 + 5 * i:7 + 5 * i] == ["sync", "clock", "call",
                                               "sync", "clock"]
    assert len(timer.samples) == 3 and rtf == 10.0 / timer.p50_latency
