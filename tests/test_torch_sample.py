"""``FlowHighSR.sample`` and the prior against the JAX package on the tiny
pair (mirroring tests/test_sr.py's sample and prior-semantics tests), and
``generate`` with the solver settings the older port tests do not reach:
``ode_method="midpoint"``, ``timestep=4`` and
``cfm_method="independent_cfm_constant"``. JAX's normal draws cannot be
made in torch, so the port gets the JAX draw through ``eps``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch.cfm import sample_prior
from test_torch_sr import TINY_MODEL, TINY_VOCODER, _configs

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

METHODS = ("basic_cfm", "independent_cfm_adaptive", "independent_cfm_constant",
           "independent_cfm_mix")


def jax_tiny(cj, **kw) -> JaxFlowHighSR:
    """The JAX package's model on ``cj``: the vector field from a real flax
    init (its norms' gains are ones), the vocoder (no norms) from fan-in
    normals with every 1-D leaf perturbed, so that the snakes' parameters
    and the biases show (as tests/test_torch_serving.py's pair)."""
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive", **kw)
    r1, r2 = jax.random.split(jax.random.PRNGKey(3))
    mel = jnp.zeros((1, 16, cj.model.dim_in))
    jsr.params = jsr.net.init(r1, mel, times=jnp.zeros(()), cond=mel)
    voc = jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2))
    leaves, tree = jax.tree_util.tree_flatten(voc)
    gen = np.random.default_rng(4)
    leaves = [np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for v in leaves]
    jsr.melvoco.vocoder_params = jax.tree_util.tree_unflatten(tree, leaves)
    return jsr


def port_of(jsr, cp, **kw) -> FlowHighSR:
    return FlowHighSR(cp, jax.device_get(jsr.params),
                      jsr.melvoco.vocoder_params, device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny_pair():
    cj, cp = _configs(TINY_MODEL, TINY_VOCODER)
    jsr = jax_tiny(cj, ode_method="midpoint")
    return jsr, port_of(jsr, cp, cfm_method="independent_cfm_adaptive",
                        ode_method="midpoint")


def _jax_draw(key: int, shape) -> np.ndarray:
    """The normal draw of the JAX package's ``sample_prior`` under
    ``PRNGKey(key)``."""
    return np.array(jax.random.normal(jax.random.PRNGKey(key), shape,
                                        jnp.float32))


# --- sample() ---------------------------------------------------------------------

# (cfm_method, cond: "mel" | "audio" | "audio3", kwargs); together they
# cover every method, both kinds of cond, cond_scale 2, mel_pp, both
# decode_to_audio settings, a frame mask and stds that make the draw count
SAMPLE_CASES = {
    "basic_mel": ("basic_cfm", "mel", dict(time_steps=2,
                                           decode_to_audio=False)),
    "adaptive_cfg2_mask": ("independent_cfm_adaptive", "mel",
                           dict(time_steps=2, cond_scale=2.0, std_1=1.0,
                                std_2=0.5, decode_to_audio=False,
                                mask=np.arange(24)[None, :] < 17)),
    "constant_audio_pp": ("independent_cfm_constant", "audio",
                          dict(time_steps=1, mel_pp=True, std_1=0.9,
                               std_2=0.3)),
    "mix_cfg2_pp": ("independent_cfm_mix", "mel",
                    dict(time_steps=1, cond_scale=2.0, mel_pp=True)),
    "basic_audio3": ("basic_cfm", "audio3", dict(time_steps=1)),
}


def _cond(kind: str, rng) -> np.ndarray:
    if kind == "mel":  # a log-mel in the codec's range
        return (rng.standard_normal((1, 24, 256)) - 4.0).astype(np.float32)
    audio = (rng.standard_normal((1, 9600)) * 0.3).astype(np.float32)
    return audio[:, None, :] if kind == "audio3" else audio


@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_sample_matches_jax(tiny_pair, rng, case):
    jsr, psr = tiny_pair
    method, kind, kw = SAMPLE_CASES[case]
    cond = _cond(kind, rng)
    jkw = {k: jnp.asarray(v) if k == "mask" else v for k, v in kw.items()}
    want = np.asarray(jsr.sample(cond=jnp.asarray(cond), cfm_method=method,
                                 rng=jax.random.PRNGKey(7), **jkw))
    n_frames = 24 if kind == "mel" else 9600 // 480  # center=False frames
    eps = _jax_draw(7, (1, n_frames, 256))
    got = psr.sample(cond=cond, cfm_method=method, eps=eps, **kw).numpy()
    assert got.shape == want.shape
    # the log-mel encode (f64 FFT against the JAX package's f32 DFT), the
    # vector field and the vocoder in other summation orders: the generate
    # bound (tests/test_torch_sr.py) for waveforms and mels alike
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_defaults_and_generator(tiny_pair, rng):
    """Without ``eps`` the prior comes from the generator (seeded 0 when
    None); an unknown cfm_method falls back to the model's; the stds
    overwrite rule of the reference: a lone std_2 is not honoured."""
    _, psr = tiny_pair
    cond = _cond("mel", rng)
    kw = dict(cond=cond, time_steps=1, decode_to_audio=False)
    a = psr.sample(cfm_method="basic_cfm", **kw)
    b = psr.sample(cfm_method="basic_cfm", generator=psr.generator(0), **kw)
    c = psr.sample(cfm_method="basic_cfm", generator=psr.generator(1), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-3
    torch.testing.assert_close(psr.sample(cfm_method="nope", **kw),
                               psr.sample(**kw), rtol=0, atol=0)
    psr.set_cfm_method("independent_cfm_constant")
    try:
        lone = psr.sample(std_2=1.0, generator=psr.generator(3), **kw)
        dflt = psr.sample(generator=psr.generator(3), **kw)
    finally:
        psr.set_cfm_method("independent_cfm_adaptive")
    torch.testing.assert_close(lone, dflt, rtol=0, atol=0)
    with pytest.raises(ValueError, match="eps shape"):
        psr.sample(eps=np.zeros((1, 3, 256), np.float32), **kw)


def test_sample_prior_eps_hook(rng):
    cond = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    cutoff = torch.tensor([3, 6])
    for method in METHODS:
        y0 = sample_prior(None, method, cond, 1.0, 0.5, cutoff, eps)
        want = {"basic_cfm": eps}.get(method, cond + 0.5 * eps)
        if method == "independent_cfm_mix":
            high = torch.arange(8)[None, None, :] >= cutoff[:, None, None]
            want = torch.where(high, eps, cond + 0.5 * eps)
        torch.testing.assert_close(y0, want, rtol=0, atol=0)


# --- the prior's semantics (tests/test_sr.py::TestPriorSemantics) ----------------

def _model(**kw) -> FlowHighSR:
    _, cp = _configs(TINY_MODEL, TINY_VOCODER)
    return FlowHighSR(cp, cfm_method="independent_cfm_adaptive",
                      ode_method="euler", device="cpu", **kw)


def test_default_stds_reference_and_paper_modes():
    m = _model()
    for method in METHODS:
        m.set_cfm_method(method)
        assert m._default_stds() == (1.0, 0.0), method
    p = _model(prior_semantics="paper")
    assert p._default_stds() == (1.0, 1.0)
    for method in ("basic_cfm", "independent_cfm_constant",
                   "independent_cfm_mix"):
        p.set_cfm_method(method)
        assert p._default_stds() == (1.0, 0.0), method
    with pytest.raises(ValueError, match="prior_semantics"):
        _model(prior_semantics="intended")


def test_paper_mode_prior_draws_noise(rng):
    m = _model(prior_semantics="paper")
    m.init_params(0)
    audio = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    a = m.generate(audio, 8000, seed=0)
    b = m.generate(audio, 8000, seed=123)
    assert np.abs(a - b).max() > 1e-6
    r = _model()
    r.init_params(0)
    np.testing.assert_array_equal(r.generate(audio, 8000, seed=0),
                                  r.generate(audio, 8000, seed=123))


# --- generate at the other solver settings -----------------------------------------

# (cfm_method, ode_method, timestep): the settings the accepted surface has
# had without a parity test
SOLVER_CASES = {"midpoint_2": ("independent_cfm_adaptive", "midpoint", 2),
                "euler_4": ("independent_cfm_adaptive", "euler", 4),
                "constant": ("independent_cfm_constant", "euler", 1)}


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_generate_solver_settings_match_jax(tiny_pair, rng, case):
    jsr, psr = tiny_pair
    method, ode, steps = SOLVER_CASES[case]
    audio = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    try:
        for m in (jsr, psr):
            m.set_cfm_method(method)
            m.ode_method = ode
        want = jsr.generate(audio, 16000, timestep=steps)
        got = psr.generate(audio, 16000, timestep=steps)
    finally:
        for m in (jsr, psr):
            m.set_cfm_method("independent_cfm_adaptive")
            m.ode_method = "midpoint"
    assert got.shape == want.shape == (1, 48000)
    # tests/test_torch_sr.py's generate bound
    np.testing.assert_allclose(got, want, atol=1e-3)
