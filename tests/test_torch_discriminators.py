"""The port's discriminators and GAN losses
(``flowhigh_tpu_torch.models.discriminators``) against the JAX package's
on the CPU, mirroring tests/test_discriminators.py.

Both packages start from the same weights: the port's seeded init, carried
into the JAX trees by the JAX package's own importer (``map_mpd_state_dict``
/ ``map_mrd_state_dict``, which reads the reference layout the port's
state dict has). The JAX side is one ``jax.jit`` of both ensembles and the
three losses at the default periods (2, 3, 5, 7, 11; 9,600 samples, so 7
and 11 reflect-pad) and the three default resolutions.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu.compat import (map_mpd_state_dict, map_mrd_state_dict,
                                 mpd_params_to_torch_state,
                                 mrd_params_to_torch_state)
from flowhigh_tpu.dsp import stft_magnitude as jax_stft_magnitude
from flowhigh_tpu.models import discriminators as jd
from flowhigh_tpu_torch.compat import mpd_state_from_jax, mrd_state_from_jax
from flowhigh_tpu_torch.dsp import stft, stft_magnitude
from flowhigh_tpu_torch.models import discriminators as pd

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

N = 9600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and torch's pool then spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(7)
    return tuple((rng.standard_normal((2, N)) * 0.3).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def modules():
    mpd = pd.init_discriminator_(pd.MultiPeriodDiscriminator(), 1)
    mrd = pd.init_discriminator_(pd.MultiResolutionDiscriminator(), 2)
    return mpd, mrd


def _losses(dl, gl, fl, outs):
    """(discriminator, generator, feature) losses of an ensemble's output,
    by either package's functions."""
    o_r, o_g, f_r, f_g = outs
    return dl(o_r, o_g)[0], gl(o_g)[0], fl(f_r, f_g)


@pytest.fixture(scope="module")
def jax_run(modules, wavs):
    """Both JAX ensembles on the port's weights, and their losses, under
    one jit."""
    mpd, mrd = modules
    params = (map_mpd_state_dict(mpd.state_dict()),
              map_mrd_state_dict(mrd.state_dict()))
    jm, jr = jd.MultiPeriodDiscriminator(), jd.MultiResolutionDiscriminator()

    @jax.jit
    def run(pm, pr, y, yh):
        outs = (jm.apply(pm, y, yh), jr.apply(pr, y, yh))
        return outs, [_losses(jd.discriminator_loss, jd.generator_loss,
                              jd.feature_loss, o) for o in outs]

    outs, losses = jax.device_get(run(*params, *map(jnp.asarray, wavs)))
    return params, outs, losses


@pytest.fixture(scope="module")
def port_run(modules, wavs):
    y, yh = (torch.from_numpy(w) for w in wavs)
    with torch.no_grad():
        outs = tuple(m(y, yh) for m in modules)
        losses = [_losses(pd.discriminator_loss, pd.generator_loss,
                          pd.feature_loss, o) for o in outs]
    return outs, losses


def _pairs(port_outs, jax_outs):
    """(port map in NHWC, JAX map) for every score and feature map."""
    p_r, p_g, pf_r, pf_g = port_outs
    j_r, j_g, jf_r, jf_g = jax_outs
    for a, b in zip(p_r + p_g, j_r + j_g):
        yield a.numpy(), np.asarray(b)
    for fa, fb in zip(pf_r + pf_g, jf_r + jf_g):
        for a, b in zip(fa, fb):
            yield a.numpy().transpose(0, 2, 3, 1), np.asarray(b)


def test_mpd_matches_jax(jax_run, port_run):
    """Every score and feature map of the five periods, of both inputs
    (measured: max abs 3.5e-7 above the 1e-5 relative allowance)."""
    n = 0
    for got, want in _pairs(port_run[0][0], jax_run[1][0]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        n += 1
    assert n == 2 * 5 + 2 * 5 * 6


def test_mrd_matches_jax(jax_run, port_run, wavs):
    """Every score and feature map of the three resolutions within rel L2
    1e-5 (measured: 2.5e-6 at most), and element-wise within rtol 1e-5 and
    an atol of 1e-5 times the map's largest |value|. Looser than the MPD's
    absolute 1e-5: the JAX package takes the magnitude as one float32
    strided conv (a DFT by direct sums), whose rounding reaches 2e-5 at
    magnitudes of 33 (measured against the float64 magnitude below), where
    the port's FFT is closer; the maps inherit that absolute error."""
    y = wavs[0]
    exact = stft(torch.from_numpy(y).double(), 2048, 240, 1200, center=False,
                 window="rect").abs().numpy()
    jax_mag = np.asarray(jax_stft_magnitude(jnp.asarray(y), 2048, 240, 1200,
                                            center=False, window="rect"))
    jax_err = float(np.abs(jax_mag - exact).max())
    n = 0
    for got, want in _pairs(port_run[0][1], jax_run[1][1]):
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (rel, jax_err)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"JAX magnitude error {jax_err}")
        n += 1
    assert n == 2 * 3 + 2 * 3 * 6


def test_losses_match_jax(jax_run, port_run):
    """The discriminator, generator and feature-matching losses of each
    ensemble within rel 1e-5 of the JAX package's on its own outputs, and
    the port's loss functions on the JAX outputs within 1e-6 of the JAX
    ones."""
    for got, want in zip(port_run[1], jax_run[2]):
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (a, b)
    for outs, want in zip(jax_run[1], jax_run[2]):
        o_r, o_g, f_r, f_g = jax.tree.map(lambda a: torch.from_numpy(
            np.asarray(a)), outs)
        got = _losses(pd.discriminator_loss, pd.generator_loss,
                      pd.feature_loss, (o_r, o_g, f_r, f_g))
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), (a, b)


def test_perfect_discriminator_losses_are_zero():
    g_loss, _ = pd.generator_loss([torch.ones(2, 10)])
    d_loss, _, _ = pd.discriminator_loss([torch.ones(2, 10)],
                                         [torch.zeros(2, 10)])
    assert float(g_loss) == 0.0 and float(d_loss) == 0.0


@pytest.mark.parametrize("which", ["mpd", "mrd"])
def test_state_dict_is_the_reference_layout(modules, which):
    """The port's state dict loads into the reference's weight-normed
    modules (tests/torch_ref.py) key for key, and their outputs and
    feature maps match the port's within 1e-5."""
    mod = modules[0 if which == "mpd" else 1]
    ref = torch_ref.TorchMPD() if which == "mpd" else torch_ref.TorchMRD()
    want_keys = set(torch_ref.torch_state_dict_weight_normed(ref))
    assert set(mod.state_dict()) == want_keys
    sd = mod.state_dict()
    if any("parametrizations" in k for k in ref.state_dict()):
        sd = {k.replace("weight_g", "parametrizations.weight.original0")
              .replace("weight_v", "parametrizations.weight.original1"): v
              for k, v in sd.items()}
    ref.load_state_dict(sd)
    rng = np.random.default_rng(3)
    y, yh = (torch.from_numpy((rng.standard_normal((2, 4800)) * 0.3)
                              .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        got = mod(y, yh)
        want = (ref(y[:, None], yh[:, None]) if which == "mpd"
                else ref(y, yh))
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for fa, fb in zip(got[2] + got[3], want[2] + want[3]):
        for a, b in zip(fa, fb):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_weight_norm_g_scales_the_weight(wavs):
    """w = g v / |v|: doubling the first conv's g doubles its feature map
    (bias zeroed; leaky ReLU is positively homogeneous)."""
    d = pd.init_discriminator_(pd.DiscriminatorP(2, kernel_size=3), 0)
    y = torch.from_numpy(wavs[0])
    with torch.no_grad():
        d.convs[0].bias.zero_()
        _, f1 = d(y)
        d.convs[0].weight_g.mul_(2.0)
        _, f2 = d(y)
    torch.testing.assert_close(f2[0], 2 * f1[0], rtol=1e-5, atol=0)


def test_init_weight_equals_v():
    """g starts at |v| over (I, kH, kW), so the initial weight is v, as
    torch's weight_norm at init; v is lecun-normal, truncated at 2
    deviations."""
    d = pd.init_discriminator_(pd.DiscriminatorP(2), 0)
    for conv in list(d.convs) + [d.conv_post]:
        v, g = conv.weight_v, conv.weight_g
        torch.testing.assert_close(
            g, torch.sqrt((v * v).sum(dim=(1, 2, 3), keepdim=True)),
            rtol=1e-6, atol=0)
        torch.testing.assert_close(conv.weight(), v, rtol=1e-6, atol=1e-7)
        std = (v[0].numel() ** -0.5) / 0.87962566103423978
        assert float(v.abs().max()) <= 2 * std
        assert float(conv.bias.abs().max()) == 0.0
    v = d.convs[2].weight_v  # 512 x 128 x 5 draws: the deviation within 2 %
    assert abs(float(v.std()) / (128 * 5) ** -0.5 - 1) < 0.02


@pytest.mark.parametrize("cls", [lambda: pd.DiscriminatorP(2, use_spectral_norm=True),
                                 lambda: pd.DiscriminatorR(
                                     (512, 50, 240), use_spectral_norm=True),
                                 lambda: pd.MultiPeriodDiscriminator(
                                     use_spectral_norm=True)])
def test_spectral_norm_fails_loudly(cls):
    with pytest.raises(NotImplementedError, match="use_spectral_norm=True"):
        cls()


@pytest.mark.parametrize("res", pd.DEFAULT_RESOLUTIONS)
def test_rect_stft_matches_jax(wavs, res):
    """``window="rect"``: ones of win_length centred in n_fft, as
    ``flowhigh_tpu.dsp.stft_magnitude(window="rect")``, within 1e-5 of
    the largest magnitude (the JAX float32 DFT's rounding; see
    test_mrd_matches_jax)."""
    y = torch.from_numpy(wavs[1])
    got = stft_magnitude(y, *res, center=False, window="rect").numpy()
    want = np.asarray(jax_stft_magnitude(jnp.asarray(wavs[1]), *res,
                                         center=False, window="rect"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="unsupported window"):
        stft_magnitude(y, *res, window="kaiser")


def test_jax_trees_map_both_ways(jax_run):
    """``mpd_state_from_jax`` / ``mrd_state_from_jax`` equal the JAX
    package's export of the same trees, and invert its importer."""
    (pm, pr), _, _ = jax_run
    pairs = ((mpd_state_from_jax(pm), mpd_params_to_torch_state(pm)),
             (mrd_state_from_jax(pr), mrd_params_to_torch_state(pr)))
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].shape == want[k].shape
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_mrd_gradient_is_finite_on_a_saturated_wave():
    """A generator output saturated at +-1 gives constant frames, whose FFT
    has exact zeros (768 of 24,672 bins here): the plain square root's
    gradient is NaN there, the MRD's magnitude gives 0, as ``torch.abs``
    in the reference, and its value stays sqrt(re^2 + im^2)."""
    x = torch.ones(1, 4800, requires_grad=True)
    spec = stft(x, 512, 50, 240, center=False, window="rect")
    power = spec.real ** 2 + spec.imag ** 2
    assert int((power == 0).sum()) > 0
    torch.sqrt(power).sum().backward()
    assert not torch.isfinite(x.grad).all()
    x.grad = None
    d = pd.init_discriminator_(pd.DiscriminatorR((512, 50, 240)), 0)
    out, fmaps = d(x)
    (out.sum() + sum(f.sum() for f in fmaps)).backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(pd._magnitude(spec), torch.sqrt(power),
                               rtol=0, atol=0)
