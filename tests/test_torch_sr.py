"""The port end to end against the JAX package: BigVGAN, the spectral
splice, and FlowHighSR.generate (euler, 1 step, independent_cfm_adaptive),
on the CPU with the JAX params carried across."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.models import BigVGAN as JaxBigVGAN
from flowhigh_tpu.postprocessing import post_process as jax_post_process
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.compat import fold_state_dict, vocoder_state_from_jax
from flowhigh_tpu_torch.models import BigVGAN
from flowhigh_tpu_torch.postprocessing import post_process

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# tests/test_sr.py's TINY config
TINY_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
TINY_VOCODER = dict(num_mels=256, upsample_initial_channel=32,
                    upsample_rates=(8, 5, 4, 3),
                    upsample_kernel_sizes=(16, 10, 8, 6),
                    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def _configs(model: dict, vocoder: dict):
    j = jcfg.FlowHighConfig().replace(model=jcfg.ModelConfig(**model),
                                      vocoder=jcfg.VocoderConfig(**vocoder))
    p = pcfg.FlowHighConfig().replace(model=pcfg.ModelConfig(**model),
                                      vocoder=pcfg.VocoderConfig(**vocoder))
    return j, p


def _perturbed_1d(params, seed: int, scale: float):
    """Flax init zeroes the snake log-alphas/betas and the biases: perturb
    every 1-D leaf so that each of them shows in the comparison."""
    leaves, tree = jax.tree_util.tree_flatten(jax.device_get(params))
    gen = np.random.default_rng(seed)
    leaves = [np.asarray(x) + (scale * gen.standard_normal(x.shape).astype(
        np.float32) if x.ndim == 1 else 0) for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


# --- BigVGAN ----------------------------------------------------------------

# one stage with the main path's resblocks (k 3/7/11 x d 1/3/5)
SMALL_VOCODER = dict(num_mels=32, upsample_initial_channel=32,
                     upsample_rates=(4,), upsample_kernel_sizes=(8,))


def test_bigvgan_matches_jax(rng):
    cfg_j = jcfg.VocoderConfig(**SMALL_VOCODER)
    mel = rng.standard_normal((1, 6, 32)).astype(np.float32)
    jvoc = JaxBigVGAN(cfg_j)
    params = _perturbed_1d(
        jax.jit(jvoc.init)(jax.random.PRNGKey(0), jnp.asarray(mel)), 2, 0.1)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    voc = BigVGAN(pcfg.VocoderConfig(**SMALL_VOCODER)).eval()
    voc.load_state_dict(vocoder_state_from_jax(params, voc.cfg))
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 6 * 4)
    # f32 convs in other summation orders, the MRF average folded into the
    # last conv (x 1/3 instead of / 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bigvgan_loads_the_reference_layout(rng):
    cfg = pcfg.VocoderConfig(**SMALL_VOCODER)
    torch.manual_seed(0)
    ref = torch_ref.TorchBigVGAN(cfg).eval()
    with torch.no_grad():  # non-trivial snake parameters
        for name, p in ref.named_parameters():
            if name.endswith((".alpha", ".beta")):
                p.normal_(0.0, 0.2)
    sd = fold_state_dict(torch_ref.torch_state_dict_weight_normed(ref))
    voc = BigVGAN(cfg).eval()
    assert ({k: tuple(v.shape) for k, v in voc.state_dict().items()}
            == {k: tuple(v.shape) for k, v in sd.items()})
    voc.load_state_dict(sd)
    mel = torch.from_numpy(rng.standard_normal((1, 6, 32)).astype(np.float32))
    with torch.no_grad():
        want = ref(mel.transpose(1, 2))[:, 0, :]
        got = voc(mel)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# --- post-processing ----------------------------------------------------------

def test_post_process_matches_jax(rng):
    n = np.arange(48000) / 48000
    src = (0.5 * np.sin(2 * np.pi * 800 * n)).astype(np.float32)[None]
    pred = (src + 0.1 * rng.standard_normal(src.shape)).astype(np.float32)
    want = np.asarray(jax_post_process(jnp.asarray(pred), jnp.asarray(src), 48000))
    got = post_process(torch.from_numpy(pred), torch.from_numpy(src), 48000).numpy()
    # FFT/iFFT vs the JAX package's f32 DFT matmuls
    np.testing.assert_allclose(got, want, atol=1e-4)


# --- generate -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    cj, cp = _configs(TINY_MODEL, TINY_VOCODER)
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler")
    jsr.init_params(jax.random.PRNGKey(0))
    psr = FlowHighSR(cp, jax.device_get(jsr.params),
                     jax.device_get(jsr.melvoco.vocoder_params),
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    return jsr, psr


@pytest.mark.parametrize("sr_in,n", [(16000, 16000), (8000, 8000)])
def test_generate_matches_jax(tiny_pair, rng, sr_in, n):
    jsr, psr = tiny_pair
    audio = (rng.standard_normal(n) * 0.3).astype(np.float32)
    want = jsr.generate(audio, sr_in, timestep=1)
    got = psr.generate(audio, sr_in, timestep=1)
    assert got.shape == want.shape == (1, n * 48000 // sr_in)
    # log-mel (f64 FFT vs the JAX package's f32 DFT), vector field and
    # vocoder in other summation orders
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_int16_input_is_bit_identical_to_float(tiny_pair, rng):
    _, psr = tiny_pair
    raw = (rng.standard_normal(8000) * 8000).astype(np.int16)
    out_i16 = psr.generate(raw, 8000, timestep=1)
    out_f32 = psr.generate(raw.astype(np.float32) / 32768.0, 8000, timestep=1)
    np.testing.assert_array_equal(out_i16, out_f32)


@pytest.mark.slow
def test_generate_matches_jax_pallas_vocoder(rng):
    """Against the JAX vocoder's Pallas path (fused_vocoder=True,
    fuse_act_conv=False: the three kernels this port replaces, in interpret
    mode) at upsample_initial_channel=512 with the main path's rates."""
    vocoder = dataclasses.asdict(jcfg.VocoderConfig(upsample_initial_channel=512))
    cj, cp = _configs(TINY_MODEL, vocoder)
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler", fused_vocoder=True,
                        fuse_act_conv=False)
    jsr.init_params(jax.random.PRNGKey(0))
    psr = FlowHighSR(cp, jax.device_get(jsr.params),
                     jax.device_get(jsr.melvoco.vocoder_params),
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    audio = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    want = jsr.generate(audio, 16000, timestep=1)
    got = psr.generate(audio, 16000, timestep=1)
    np.testing.assert_allclose(got, want, atol=1e-3)
