"""The port's reduced-precision vocoder as a whole (``BigVGAN(conv_dtype=)``,
``FlowHighSR(vocoder_conv_dtype=)``) against the JAX package's fused
Pallas vocoder (``fused_vocoder=True``) with the same ``conv_dtype``, on
the CPU in interpret mode. Kernel by kernel: tests/test_torch_dot_dtype.py.

Two implementations of a bf16 or int8 network that differ only in f32
summation order do not stay within f32 rounding of each other: now and
then an activation lies within an f32 ulp of a bf16 rounding (or int8
quantisation) boundary, the two round it apart, and the next layer's
inputs then differ by a whole bf16 step (or quantum), not an ulp; that
moves more roundings downstream. In the tiny vocoder below one such flip
in the first unit (1 of 1,024 activations, f32 difference 3.6e-7) grows
to 2.4e-3 relative L2 at the output. So the whole vocoder is held to the
JAX one element-wise only where nothing flips (int8 with one window per
sequence); bf16 elsewhere must stay well below the distance the reduction
itself puts between it and the f32 output. int8 over several windows is
another quantisation on each side (``ops/quant.py``), so there both are
held to the JAX package's quantisation-grade bound
(tests/test_packed.py::TestInt8Dots::test_int8_full_generator_close)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.compat.jax_params import vocoder_state_from_jax
from flowhigh_tpu_torch.models import BigVGAN

JDT = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}
# bf16: the port's distance from the JAX output, as a share of the
# reduction's own distance from the f32 output (measured 0.36 and 0.61)
FLIP_SHARE = 0.75


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _perturbed(params, seed):
    """Every 1-D leaf (snake parameters, biases) moved so that each shows."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    gen = np.random.default_rng(seed)
    leaves = [np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for v in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


# two stages: C = 32 (packed p = 8 in the JAX package) and C = 16 (p = 16),
# k = 3 and k = 7 blocks; at 8 mel frames every conv of every stage is one
# window on both sides (T = 32 and 128 samples), at 40 frames several
TINY_VOCODER = dict(num_mels=16, upsample_initial_channel=64,
                    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                    resblock_kernel_sizes=(3, 7),
                    resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def tiny_vocoders():
    """(JAX params, port state dict) of one seeded tiny vocoder."""
    cfg = jcfg.VocoderConfig(**TINY_VOCODER)
    mel = jnp.zeros((1, 8, cfg.num_mels))
    params = _perturbed(jax.device_get(_fast_init(
        lambda r: JaxBigVGAN(cfg).init(r, mel), jax.random.PRNGKey(3))), 4)
    return params, vocoder_state_from_jax(
        params, pcfg.VocoderConfig(**TINY_VOCODER))


def _port_vocoder(state, conv_dtype):
    voc = BigVGAN(pcfg.VocoderConfig(**TINY_VOCODER),
                  conv_dtype=conv_dtype).eval()
    voc.load_state_dict(state)
    return voc


@pytest.mark.parametrize("dot_dtype,frames", [(torch.bfloat16, 40),
                                              (torch.int8, 8)])
def test_vocoder_matches_jax_fused(rng, tiny_vocoders, dot_dtype, frames):
    params, state = tiny_vocoders
    jvoc = JaxBigVGAN(jcfg.VocoderConfig(**TINY_VOCODER), fused_act=True,
                      packed=True, pallas_convs=True, fuse_act_conv=True,
                      conv_dtype=JDT[dot_dtype])
    mel = (rng.standard_normal((1, frames, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = _port_vocoder(state, dot_dtype)(torch.from_numpy(mel)).numpy()
        f32 = _port_vocoder(state, None)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    print(f"{dot_dtype}, {frames} frames: port vs JAX rel L2 "
          f"{_rel(got, want):.3e}, max abs {np.abs(got - want).max():.3e}; "
          f"port vs its f32 {_rel(got, f32):.3e}")
    if dot_dtype == torch.int8:  # one window per conv, no flips
        assert _rel(got, want) <= 1e-3
        assert _rel(got, f32) > 1e-3  # the dots really were quantised
    else:
        assert _rel(got, want) <= FLIP_SHARE * _rel(got, f32)


SMALL_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
SMALL_VOCODER = dict(num_mels=256, upsample_initial_channel=64,
                     upsample_rates=(8, 5, 4, 3),
                     upsample_kernel_sizes=(16, 11, 8, 7),
                     resblock_kernel_sizes=(3, 11),
                     resblock_dilation_sizes=((1,), (5,)))


@pytest.mark.parametrize("dot_dtype", ["bfloat16", "int8"])
def test_generate_matches_jax_fused_vocoder(rng, dot_dtype):
    # tests/test_torch_fused.py's small config; the 1 s clip spans many
    # windows
    cj = jcfg.FlowHighConfig().replace(
        model=jcfg.ModelConfig(**SMALL_MODEL),
        vocoder=jcfg.VocoderConfig(**SMALL_VOCODER))
    cp = pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**SMALL_MODEL),
        vocoder=pcfg.VocoderConfig(**SMALL_VOCODER))
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler", fused_vocoder=True,
                        vocoder_conv_dtype=getattr(jnp, dot_dtype))
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    mel = jnp.zeros((1, 16, 256))
    jsr.params = jsr.net.init(r1, mel, times=jnp.zeros(()), cond=mel)
    jsr.melvoco.vocoder_params = _perturbed(jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2)), 2)
    kw = dict(cfm_method="independent_cfm_adaptive", ode_method="euler",
              device="cpu")
    psr = FlowHighSR(cp, jax.device_get(jsr.params),
                     jsr.melvoco.vocoder_params, vocoder_conv_dtype=dot_dtype,
                     **kw)
    f32 = FlowHighSR(cp, jax.device_get(jsr.params),
                     jsr.melvoco.vocoder_params, **kw)
    assert psr.vocoder.conv_dtype == getattr(torch, dot_dtype)
    audio = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    want = jsr.generate(audio, 16000, timestep=1)
    got = psr.generate(audio, 16000, timestep=1)
    ref = f32.generate(audio, 16000, timestep=1)
    assert got.shape == want.shape == (1, 48000) and np.isfinite(got).all()
    print(f"{dot_dtype}: port vs JAX rel L2 {_rel(got, want):.3e}, max abs "
          f"{np.abs(got - want).max():.3e}; port vs its f32 "
          f"{_rel(got, ref):.3e}")
    if dot_dtype == "int8":
        # other windows on each side: two quantisations of one function,
        # each within the JAX package's bound of the f32 output
        assert _rel(got, want) < 0.1 and _rel(got, ref) < 0.1
        assert _rel(want, ref) < 0.1
    else:
        assert _rel(got, want) <= FLIP_SHARE * _rel(got, ref)
