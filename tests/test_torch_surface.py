"""The front-end and vocoder options of the port against the JAX package on
the CPU: the soxr_hq resampler design (``upsampling_method="librosa"``),
the HTK mel bank and ``encode_torchaudio``, the ``MelVoco`` surface,
``post_process_with_phase``, and BigVGAN with resblock "2" (``AMPBlock2``),
from JAX params and from a reference-layout checkpoint loaded by
``from_local``."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.compat.torch_ckpt import vocoder_params_to_torch_state
from flowhigh_tpu.dsp import resample as jax_resample
from flowhigh_tpu.dsp.mel import mel_filterbank_htk as jax_htk
from flowhigh_tpu.models import BigVGAN as JaxBigVGAN
from flowhigh_tpu.models.melvoco import MelVoco as JaxMelVoco
from flowhigh_tpu.models.melvoco import encode_torchaudio as jax_encode_ta
from flowhigh_tpu.postprocessing import (post_process_with_phase as
                                         jax_post_process_with_phase)
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.cfm import cutoff_bins_from_energy
from flowhigh_tpu_torch.compat import vocoder_state_from_jax
from flowhigh_tpu_torch.dsp import (mel_filterbank_htk, resample_poly, stft,
                                    upsample_to_48k)
from flowhigh_tpu_torch.dsp import resample as port_resample
from flowhigh_tpu_torch.models import BigVGAN, MelVoco, encode_torchaudio
from flowhigh_tpu_torch.models import mel_encode
from flowhigh_tpu_torch.postprocessing import post_process_with_phase
from test_torch_sample import jax_tiny, port_of
from test_torch_sr import (TINY_MODEL, TINY_VOCODER, _configs,
                           _perturbed_1d)

RATES = {16000: (3, 1), 8000: (6, 1), 44100: (160, 147)}


# --- the soxr_hq design -------------------------------------------------------------

@pytest.mark.parametrize("sr", RATES)
def test_soxr_hq_taps_equal_jax(sr):
    up, down = RATES[sr]
    h, pre, half = port_resample._design(up, down, "soxr_hq")
    hj, prej, halfj = jax_resample._design(up, down, "soxr_hq")
    np.testing.assert_array_equal(h, hj)
    assert (pre, half) == (prej, halfj) == (pre, 32 * max(up, down))
    w, s0, kw = port_resample._polyphase_bank(up, down, "soxr_hq")
    wj, s0j, kwj = jax_resample._polyphase_bank(up, down, "soxr_hq")
    np.testing.assert_array_equal(w, wj)
    assert (s0, kw) == (s0j, kwj) and w.shape[0] == up
    if sr == 44100:  # 160 phases of about 64 taps each
        taps = (w != 0).sum(axis=1)
        assert taps.min() >= 63 and taps.max() <= 65, (taps.min(), taps.max())
    # not the scipy design
    assert len(h) != len(port_resample._design(up, down, "scipy")[0])


@pytest.mark.parametrize("sr", RATES)
def test_resample_soxr_hq_matches_jax(rng, sr):
    x = (rng.standard_normal((2, sr // 4)) * 0.3).astype(np.float32)
    want = np.asarray(jax_resample.resample_poly(jnp.asarray(x), 48000, sr,
                                                 "soxr_hq"))
    got = resample_poly(torch.from_numpy(x), 48000, sr, "soxr_hq").numpy()
    assert got.shape == want.shape
    # tests/test_torch_dsp.py's resampler bound
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        upsample_to_48k(torch.from_numpy(x), sr, design="soxr_hq").numpy(),
        got)
    with pytest.raises(ValueError, match="design"):
        resample_poly(torch.from_numpy(x), 48000, sr, "kaiser_best")


@pytest.fixture(scope="module")
def librosa_pair():
    cj, cp = _configs(TINY_MODEL, TINY_VOCODER)
    jsr = jax_tiny(cj, ode_method="euler", upsampling_method="librosa")
    return jsr, port_of(jsr, cp, cfm_method="independent_cfm_adaptive",
                        ode_method="euler", upsampling_method="librosa")


@pytest.mark.parametrize("sr", [16000, 44100])
def test_generate_librosa_matches_jax(librosa_pair, rng, sr):
    jsr, psr = librosa_pair
    audio = (rng.standard_normal(sr) * 0.3).astype(np.float32)
    want = jsr.generate(audio, sr, timestep=1)
    got = psr.generate(audio, sr, timestep=1)
    assert got.shape == want.shape == (1, 48000)
    # tests/test_torch_sr.py's generate bound
    np.testing.assert_allclose(got, want, atol=1e-3)
    with pytest.raises(ValueError, match="upsampling_method"):
        FlowHighSR(psr.config, upsampling_method="torchaudio", device="cpu")


# --- the torchaudio encode ---------------------------------------------------------

def test_htk_filterbank_matches_jax():
    fb = mel_filterbank_htk(48000, 2048, 256, 0.0, 24000.0)
    np.testing.assert_array_equal(fb, jax_htk(48000, 2048, 256, 0.0, 24000.0))
    assert fb.shape == (256, 1025) and fb.max() > 0.5  # no Slaney norm


@pytest.mark.parametrize("log", [True, False])
def test_encode_torchaudio_matches_jax(rng, log):
    x = (rng.standard_normal((2, 24000)) * 0.3).astype(np.float32)
    x[1, 12000:] = 0.0  # silence: the 1e-10 clamp engages
    cfg = jcfg.MelConfig()
    want = np.asarray(jax_encode_ta(jnp.asarray(x), cfg, log=log))
    got = encode_torchaudio(torch.from_numpy(x), pcfg.MelConfig(), log).numpy()
    assert got.shape == want.shape == (2, 51, 256)
    if log:  # decibels: the JAX package's f32 DFT against an f64 FFT
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)
        assert got.min() == pytest.approx(-100.0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-5 * float(want.max()))


# --- MelVoco -------------------------------------------------------------------------

def _jax_vocoder_params(jvoc, num_mels: int, seed: int):
    """JAX BigVGAN params from fan-in normals (shapes by ``eval_shape``, no
    compile of the init) with every 1-D leaf perturbed, so that the
    snakes' parameters and the biases show."""
    params = _fast_init(lambda r: jvoc.init(r, jnp.zeros((1, 4, num_mels))),
                        jax.random.PRNGKey(seed))
    return _perturbed_1d(params, seed + 2, 0.1)


SMALL_MEL = dict(n_mels=32, n_fft=256, win_length=256, hop_length=64,
                 sampling_rate=16000, f_max=8000.0)
# the mel's hop = prod(rates)
SMALL_VOC = dict(num_mels=32, upsample_initial_channel=16,
                 upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


@pytest.fixture(scope="module")
def melvoco_pair():
    jm = JaxMelVoco(jcfg.MelConfig(**SMALL_MEL), jcfg.VocoderConfig(**SMALL_VOC))
    params = _jax_vocoder_params(jm.vocoder, 32, 0)
    jm.vocoder_params = params
    pm = MelVoco(pcfg.MelConfig(**SMALL_MEL), pcfg.VocoderConfig(**SMALL_VOC),
                 jax.device_get(params), device="cpu")
    return jm, pm


def test_melvoco_surface_matches_jax(melvoco_pair, rng):
    jm, pm = melvoco_pair
    for attr in ("n_mels", "sampling_rate", "hop_length", "win_length",
                 "latent_dim"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    mel = rng.standard_normal((2, 9, 32)).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(mel)))
    got = pm.decode(mel)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    # tests/test_torch_sr.py::test_bigvgan_matches_jax's bound
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    audio = (rng.standard_normal((2, 1600)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(pm.encode(audio).numpy(),
                               np.asarray(jm.encode(jnp.asarray(audio))),
                               atol=1e-3)
    np.testing.assert_allclose(
        pm.encode_torchaudio(audio).numpy(),
        np.asarray(jm.encode_torchaudio(jnp.asarray(audio))),
        atol=3e-2, rtol=1e-3)


def test_melvoco_reference_keywords(tmp_path, rng):
    """The reference's constructor keywords: mel settings, a vocoder JSON
    (``vocoder_config``) and a weight-normed generator file
    (``vocoder_path``); the JAX package's TPU switches are validated."""
    cfg = pcfg.VocoderConfig(**SMALL_VOC)
    (tmp_path / "voc.json").write_text(json.dumps(
        {**SMALL_VOC, "upsample_rates": [8, 8], "resblock": "1",
         "resblock_dilation_sizes": [[1, 3]]}))
    torch.manual_seed(0)
    ref = torch_ref.TorchBigVGAN(cfg).eval()
    torch.save({"generator": torch_ref.torch_state_dict_weight_normed(ref)},
               tmp_path / "g.pt")
    m = MelVoco(n_mels=32, n_fft=256, win_length=256, hop_length=64,
                sampling_rate=16000, f_max=8000.0,
                vocoder_config=tmp_path / "voc.json",
                vocoder_path=tmp_path / "g.pt", log=False, fused_act=True,
                packed=True, pallas_convs=True, kernel_pipeline=2,
                device="cpu")
    assert m.mel_cfg == pcfg.MelConfig(**SMALL_MEL) and m.voc_cfg == cfg
    mel = torch.from_numpy(rng.standard_normal((1, 6, 32)).astype(np.float32))
    with torch.no_grad():
        want = ref(mel.transpose(1, 2))[:, 0, :]
    torch.testing.assert_close(m.decode(mel), want, atol=1e-4, rtol=0)
    assert (m.encode_torchaudio(np.zeros((1, 640), np.float32)) == 0).all()
    assert MelVoco(device="cpu").latent_dim == 256
    assert MelVoco(device="cpu", storage_dtype=torch.bfloat16
                   ).vocoder.storage_dtype == torch.bfloat16
    for kw, match in ((dict(storage_dtype=torch.float16), "storage_dtype"),
                      (dict(fused_act="yes"), "fused_act"),
                      (dict(kernel_pipeline=0), "kernel_pipeline"),
                      (dict(vocoder="hifigan"), "vocoder"),
                      (dict(dtype=torch.float16), "dtype")):
        with pytest.raises((ValueError, NotImplementedError), match=match):
            MelVoco(device="cpu", **kw)


# --- the phase splice -----------------------------------------------------------------

def _splice_inputs(rng, dc: bool):
    n = np.arange(24000) / 48000
    if dc:  # a slow swell: its energy in bins 0 and 1, the cutoff 0
        src = (0.5 * np.hanning(24000)).astype(np.float32)
    else:
        src = (np.sin(2 * np.pi * 500 * n)
               + 0.01 * rng.standard_normal(24000)).astype(np.float32)
    pred = (0.9 * np.sin(2 * np.pi * 500 * n)
            + 0.2 * np.sin(2 * np.pi * 15000 * n)
            + 0.01 * rng.standard_normal(24000)).astype(np.float32)
    return pred[None], src[None]


@pytest.mark.parametrize("dc", [False, True], ids=["tone", "cutoff_clamped"])
def test_post_process_with_phase_matches_jax(rng, dc):
    pred, src = _splice_inputs(rng, dc)
    want = np.asarray(jax_post_process_with_phase(jnp.asarray(pred),
                                                  jnp.asarray(src), 24000))
    got = post_process_with_phase(torch.from_numpy(pred),
                                  torch.from_numpy(src), 24000).numpy()
    energy = torch.sum(torch.abs(stft(torch.from_numpy(src), 2048, 480, 2048,
                                      center=True, pad_mode="constant")), -1)
    cr = int(cutoff_bins_from_energy(energy, 0.99)[0])
    assert (cr == 0) == dc  # the clamp to 1 engages on the DC input
    assert got.shape == want.shape == (1, 24000)
    # tests/test_torch_sr.py::test_post_process_matches_jax's bound
    np.testing.assert_allclose(got, want, atol=1e-4)


# --- AMPBlock2 -------------------------------------------------------------------------

# one stage, the published resblock kernels and dilations, resblock "2"
SMALL_VOCODER2 = dict(num_mels=32, upsample_initial_channel=32,
                      upsample_rates=(4,), upsample_kernel_sizes=(8,),
                      resblock="2")


def test_bigvgan_resblock2_matches_jax(rng):
    cfg_j = jcfg.VocoderConfig(**SMALL_VOCODER2)
    mel = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jvoc = JaxBigVGAN(cfg_j)
    params = _jax_vocoder_params(jvoc, 32, 0)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    cfg = pcfg.VocoderConfig(**SMALL_VOCODER2)
    for fuse in (True, False):  # AMPBlock2 takes A and B either way
        voc = BigVGAN(cfg, fuse_act_conv=fuse).eval()
        voc.load_state_dict(vocoder_state_from_jax(params, cfg))
        assert sorted(voc.resblocks[0].state_dict())[:3] == [
            "activations.0.act.alpha", "activations.0.act.beta",
            "activations.0.downsample.filter"]
        with torch.no_grad():
            got = voc(torch.from_numpy(mel)).numpy()
        assert got.shape == want.shape == (2, 24)
        # the vocoder blocks' bound (tests/test_packed.py, 2e-5 to 1e-4)
        np.testing.assert_allclose(got, want, atol=1e-4)
    bf16 = BigVGAN(cfg, conv_dtype=torch.bfloat16)
    assert all(b.dot_dtype == torch.bfloat16 for b in bf16.resblocks)
    with pytest.raises(ValueError, match="resblock"):
        BigVGAN(pcfg.VocoderConfig(resblock="3"))


FILE_VOCODER2 = dict(num_mels=256, upsample_initial_channel=32,
                     upsample_rates=(8, 5, 4, 3),
                     upsample_kernel_sizes=(16, 10, 8, 6), resblock="2",
                     resblock_kernel_sizes=(3, 7),
                     resblock_dilation_sizes=((1, 3), (1, 3, 5)))


def test_from_local_loads_a_resblock2_checkpoint(tmp_path, rng):
    """A reference-layout directory whose vocoder JSON says resblock "2":
    the generator file is the JAX package's export of JAX params
    (``resblocks.{n}.convs.{j}``, ``activations.{j}``, weight-normed)."""
    cfg_j = jcfg.VocoderConfig(**FILE_VOCODER2)
    jvoc = JaxBigVGAN(cfg_j)
    params = _jax_vocoder_params(jvoc, 256, 1)
    sd = vocoder_params_to_torch_state(params, cfg_j)
    assert "resblocks.1.convs.2.weight_v" in sd
    torch.save({"generator": sd}, tmp_path / "bigvgan_48khz_256band.pt")
    (tmp_path / "bigvgan_48khz_256band.json").write_text(json.dumps(
        {**FILE_VOCODER2, "upsample_rates": [8, 5, 4, 3],
         "resblock_dilation_sizes": [[1, 3], [1, 3, 5]],
         "activation": "snakebeta", "snake_logscale": True}))
    wrap = torch_ref.TorchCFMWrapper(**{k: TINY_MODEL[k] for k in (
        "dim_in", "dim", "depth", "dim_head", "heads")}).eval()
    torch.save({"model": dict(wrap.state_dict())},
               tmp_path / "FLowHigh_basic_400k.pt")
    sr = FlowHighSR.from_local(tmp_path, device="cpu",
                               model_config=pcfg.ModelConfig(**TINY_MODEL),
                               cfm_method="independent_cfm_adaptive",
                               ode_method="euler")
    assert sr.config.vocoder.resblock == "2"
    mel = rng.standard_normal((1, 5, 256)).astype(np.float32)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = sr.vocoder(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    out = sr.generate((rng.standard_normal(8000) * 0.3).astype(np.float32),
                      8000)
    assert out.shape == (1, 48000) and np.isfinite(out).all()
    # the mel codec's encode is the FlowHighSR pipeline's
    x = torch.from_numpy((rng.standard_normal((1, 4800)) * 0.3).astype(
        np.float32))
    torch.testing.assert_close(MelVoco(device="cpu").encode(x),
                               mel_encode(x), rtol=0, atol=0)


# AMPBlock2 and conv_post at an unpacked stage (C = 256: p = 1), where the
# JAX package's fused vocoder runs XLA's float32 conv1d whatever conv_dtype
# says; and at a packed stage (C = 16, 16 samples: p = 16), where its
# packed_conv1d refuses int8
P1_VOCODER2 = dict(num_mels=32, upsample_initial_channel=512,
                   upsample_rates=(2,), upsample_kernel_sizes=(4,),
                   resblock="2", resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1, 3),))


@pytest.mark.parametrize("dot", ["bfloat16", "int8"])
def test_ampblock2_and_conv_post_dots_follow_the_jax_package(rng, dot):
    cfg_j = jcfg.VocoderConfig(**P1_VOCODER2)
    params = _jax_vocoder_params(JaxBigVGAN(cfg_j), 32, 5)
    # fused_act stays off: the JAX fused snake departs from its own
    # composition on channels >= 128 at C = 256 on the CPU (ROADMAP.md
    # queue 3 item 18); the dot dtypes follow packed and pallas_convs
    jvoc = JaxBigVGAN(cfg_j, packed=True, pallas_convs=True,
                      fuse_act_conv=True, conv_dtype=getattr(jnp, dot))
    mel = rng.standard_normal((1, 64, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    cfg = pcfg.VocoderConfig(**P1_VOCODER2)
    assert BigVGAN._pack_factor(256, 128) == 1
    voc = BigVGAN(cfg, conv_dtype=getattr(torch, dot)).eval()
    voc.load_state_dict(vocoder_state_from_jax(params, cfg))
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
    if dot == "int8":  # everything float32 (_boundary_dtype): the vocoder
        # blocks' bound (tests/test_packed.py); dots at int8: 4.8e-2
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:  # the upsampler's bf16 dots (both sides) may round a few inputs
        # a step apart: rel L2 2.2e-5 here; AMPBlock2 on bf16 dots: 4.0e-3
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel


def test_int8_in_a_packed_ampblock2_stage_raises_as_in_jax():
    packs = dict(P1_VOCODER2, upsample_initial_channel=32)
    assert BigVGAN._pack_factor(16, 16) == 16
    mel8 = jnp.zeros((1, 8, 32))
    with pytest.raises(ValueError, match="int8"):
        jax.eval_shape(JaxBigVGAN(
            jcfg.VocoderConfig(**packs), packed=True, pallas_convs=True,
            conv_dtype=jnp.int8).apply,
            _jax_vocoder_params(JaxBigVGAN(jcfg.VocoderConfig(**packs)), 32,
                                6), mel8)
    with pytest.raises(ValueError, match="int8"), torch.no_grad():
        BigVGAN(pcfg.VocoderConfig(**packs), conv_dtype=torch.int8)(
            torch.zeros(1, 8, 32))
