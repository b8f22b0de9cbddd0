"""The port's CFM training loss against the JAX package's on the CPU
(``flowhigh_tpu_torch.cfm``: ``sample_path``, ``cfm_loss``,
``freq_mask_cond``, ``crop_segments``, ``cfm_training_loss``; the
wrapper's ``forward``), the vector field's dropout, and kernel F's plain
version under autograd.

JAX's draws cannot be made in torch: each comparison draws with JAX from
the key the JAX function splits, in its order, and hands the port the same
numbers as a ``TrainingDraws``. The field is tests/test_train.py's
TINY_CFG one (dim 32, depth 2, 2 x 8 heads, 256 mels); its weights cross
through ``compat.vector_field_state_from_jax``.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import ConditionalFlowMatcherWrapper as JaxWrapper
from flowhigh_tpu import FLowHigh as JaxFLowHigh
from flowhigh_tpu import cfm as jcfm
from flowhigh_tpu.config import MelConfig as JaxMelConfig
from flowhigh_tpu.config import ModelConfig as JaxModelConfig
from flowhigh_tpu.config import VocoderConfig as JaxVocoderConfig
from flowhigh_tpu.models import MelVoco as JaxMelVoco
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu_torch import ConditionalFlowMatcherWrapper, FLowHigh
from flowhigh_tpu_torch import cfm as pcfm
from flowhigh_tpu_torch.compat import vector_field_state_from_jax
from flowhigh_tpu_torch.config import MelConfig, ModelConfig, VocoderConfig
from flowhigh_tpu_torch.models import MelVoco, VectorFieldNet
from flowhigh_tpu_torch.models import transformer as ptransformer
from flowhigh_tpu_torch.ops import flash_attn
from test_torch_vector_options import _field_params

FIELD = dict(dim_in=256, dim=32, depth=2, heads=2, dim_head=8)
OUT = 200  # the trainers' crop: 2 s at 100 frames a second
METHODS = pcfm.CFM_METHODS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs several
    workers on the machine's cores, and torch's thread pool then spins
    against theirs (a ``fit`` of this file took 27 s under four workers
    with the default pool, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(rng, shape):
    """The draws of ``flowhigh_tpu.cfm.cfm_training_loss(rng, ...)`` for
    mels of ``shape``, made as it makes them."""
    b, _, m = shape
    r_t, r_path, r_crop, r_drop, r_fm, _ = jax.random.split(rng, 6)
    r_h, r_s = jax.random.split(r_fm)
    return (jax.random.uniform(r_t, (b,)), jax.random.normal(r_path, shape),
            jax.random.uniform(r_crop, (b,)), jax.random.uniform(r_drop, (b,)),
            jax.random.randint(r_h, (b,), 10, 21),
            jax.random.randint(r_s, (b,), 20, m - 20))


_jax_draws_jit = jax.jit(_jax_draws, static_argnums=1)


def jax_draws(rng, shape) -> pcfm.TrainingDraws:
    """``_jax_draws`` as the port's ``TrainingDraws`` on the CPU."""
    return pcfm.TrainingDraws(*(torch.from_numpy(np.array(a))
                                for a in _jax_draws_jit(rng, tuple(shape))))


def _mels(b, t, seed):
    """(x1, cond) log-mels: cond is x1 with its bins >= 150 at the log
    clamp, a band-limited condition with a cutoff to find."""
    gen = np.random.default_rng(seed)
    x1 = (gen.standard_normal((b, t, 256)) - 4.0).astype(np.float32)
    cond = x1.copy()
    cond[..., 150:] = np.float32(np.log(1e-5))
    return x1, cond


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(got - want) <= rtol * abs(want), (got, want)


# --- the pieces -------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_sample_path_matches_jax(method):
    x1, cond = _mels(2, 20, 0)
    rng = jax.random.PRNGKey(3)
    t = jax.random.uniform(jax.random.PRNGKey(4), (2,))
    want = jcfm.sample_path(rng, method, jnp.asarray(x1), jnp.asarray(cond),
                            t, 1e-4)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, x1.shape)))
    got = pcfm.sample_path(method, torch.from_numpy(x1),
                           torch.from_numpy(cond),
                           torch.from_numpy(np.array(t)), 1e-4, eps)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


LOSS_CASES = {"plain": {}, "masked": {"mask": True},
              "weighted": {"weighted": True},
              "weighted_masked": {"weighted": True, "mask": True}}


@pytest.mark.parametrize("case", LOSS_CASES)
def test_cfm_loss_matches_jax(case):
    kw = LOSS_CASES[case]
    pred, target = _mels(3, 16, 1)
    mask = np.arange(16)[None, :] < np.array([16, 9, 0])[:, None]
    cutoff = np.array([150, 3, 255])
    jkw = dict(weighted=kw.get("weighted", False),
               mask=jnp.asarray(mask) if kw.get("mask") else None,
               cutoff=jnp.asarray(cutoff) if kw.get("weighted") else None)
    pkw = dict(weighted=jkw["weighted"],
               mask=torch.from_numpy(mask) if kw.get("mask") else None,
               cutoff=torch.from_numpy(cutoff) if kw.get("weighted") else None)
    want = jcfm.cfm_loss(jnp.asarray(pred), jnp.asarray(target), **jkw)
    got = pcfm.cfm_loss(torch.from_numpy(pred), torch.from_numpy(target),
                        **pkw)
    _close(got, want, 1e-6)


def test_weighted_cfm_loss_needs_the_cutoff():
    pred, target = _mels(1, 4, 2)
    with pytest.raises(AssertionError):
        jcfm.cfm_loss(jnp.asarray(pred), jnp.asarray(target), weighted=True)
    with pytest.raises(ValueError, match="cutoff"):
        pcfm.cfm_loss(torch.from_numpy(pred), torch.from_numpy(target),
                      weighted=True)


def test_freq_mask_cond_matches_jax():
    _, cond = _mels(4, 12, 3)
    rng = jax.random.PRNGKey(5)
    want = jcfm.freq_mask_cond(rng, jnp.asarray(cond))
    r_h, r_s = jax.random.split(rng)  # freq_mask_cond's own split
    height = torch.from_numpy(np.array(jax.random.randint(r_h, (4,), 10, 21)))
    start = torch.from_numpy(np.array(jax.random.randint(r_s, (4,), 20,
                                                         256 - 20)))
    got = pcfm.freq_mask_cond(torch.from_numpy(cond), height, start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != cond).any(axis=(1, 2)).all()  # every item masked
    # the port's own draws span the same bands
    d = pcfm.draw_training(torch.Generator().manual_seed(0), (400, 2, 256),
                           "cpu")
    assert (d.fm_height.min(), d.fm_height.max()) == (10, 20)
    assert (d.fm_start.min(), d.fm_start.max()) == (20, 256 - 21)


# frames of the batch, valid frames of each item: a batch longer than the
# crop (items longer and shorter than it) and one shorter (zero-padded)
CROPS = {"crop": (250, [247, 171, 121]), "pad": (150, [150, 90, 1])}


@pytest.mark.parametrize("case", CROPS)
def test_crop_segments_matches_jax(case):
    t, lengths = CROPS[case]
    arrays = _mels(3, t, 4)
    rng = jax.random.PRNGKey(6)
    (wa, wb), wmask = jcfm.crop_segments(
        rng, tuple(jnp.asarray(a) for a in arrays), jnp.asarray(lengths), OUT)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (3,))))
    (ga, gb), gmask = pcfm.crop_segments(
        tuple(torch.from_numpy(a) for a in arrays), torch.tensor(lengths),
        OUT, u)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    assert gmask.sum(1).tolist() == [min(n, OUT) for n in lengths]


# --- the whole loss and its gradients ------------------------------------------------

# one case a path; between them a condition drop, the frequency mask, the
# cutoff-weighted loss, whole sequences (out_size 0) and a batch shorter
# than the crop
CASES = {
    "basic_cfm": dict(t=250, cond_drop_prob=0.5),
    "independent_cfm_adaptive": dict(t=150, cond_freq_masking=True,
                                     sigma=1e-4),
    "independent_cfm_constant": dict(t=120, out_size=0, sigma=1e-4),
    "independent_cfm_mix": dict(t=250, cond_drop_prob=0.4, weighted=True,
                                cond_freq_masking=True),
}
LENGTHS = {250: [247, 171, 121], 150: [150, 90, 60], 120: [120, 77, 30]}


@functools.lru_cache(maxsize=None)
def _jax_net(compute_dtype="float32"):
    jnet = JaxVectorFieldNet(JaxModelConfig(compute_dtype=compute_dtype,
                                            **FIELD))
    return jnet, _field_params(JaxVectorFieldNet(JaxModelConfig(**FIELD)))


def _jax_loss_and_grads(method, compute_dtype, x1, cond, lengths, rng, kw):
    """value_and_grad of the JAX loss, compiled without XLA's excess
    precision (so that a bf16 program rounds where it says it does)."""
    jnet, params = _jax_net(compute_dtype)
    opts = dict(method=method, sigma=kw.get("sigma", 0.0),
                out_size=kw.get("out_size", OUT),
                cond_drop_prob=kw.get("cond_drop_prob", 0.0),
                weighted=kw.get("weighted", False),
                cond_freq_masking=kw.get("cond_freq_masking", False))

    def loss(p, r, a, c, n):
        return jcfm.cfm_training_loss(jnet.apply, p, r, a, c, n, **opts)

    args = (params, rng, jnp.asarray(x1), jnp.asarray(cond),
            jnp.asarray(lengths))
    fn = jax.jit(jax.value_and_grad(loss))
    val, grads = fn.lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)
    return float(val), vector_field_state_from_jax(jax.device_get(grads),
                                                   ModelConfig(**FIELD))


def _port_loss_and_grads(method, compute_dtype, x1, cond, lengths, rng, kw):
    cfg = ModelConfig(compute_dtype=compute_dtype, **FIELD)
    net = VectorFieldNet(cfg)
    net.load_state_dict(vector_field_state_from_jax(_jax_net()[1], cfg))
    net.null_cond.requires_grad_(True)
    loss = pcfm.cfm_training_loss(
        net, torch.from_numpy(x1), torch.from_numpy(cond),
        torch.tensor(lengths), method=method, sigma=kw.get("sigma", 0.0),
        out_size=kw.get("out_size", OUT),
        cond_drop_prob=kw.get("cond_drop_prob", 0.0),
        weighted=kw.get("weighted", False),
        cond_freq_masking=kw.get("cond_freq_masking", False),
        draws=jax_draws(rng, x1.shape))
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in
                                  net.named_parameters()}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# the q- and k-norm gains' gradients: rel L2 bound. They sit behind the
# scale-10 scores, and a sum that cancels to a few per mille of its terms
# makes them float32 rounding's: one float32 step on the mels (x (1 +-
# 2^-23)) moves the port's own by up to 1.1e-5, and port and JAX differ by
# up to 1.4e-5 (measured over the four cases below); every other leaf
# differs by at most 7e-7
GAIN_TOL = 5e-5


@pytest.mark.parametrize("method", METHODS)
def test_training_loss_and_grads_match_jax(method):
    """Loss within rel 1e-5; the whole gradient and each leaf's within rel
    L2 1e-5, the q- and k-norm gains' within ``GAIN_TOL``."""
    kw = CASES[method]
    x1, cond = _mels(3, kw["t"], 7)
    lengths = LENGTHS[kw["t"]]
    rng = jax.random.PRNGKey(11)
    want, wgrads = _jax_loss_and_grads(method, "float32", x1, cond, lengths,
                                       rng, kw)
    got, pgrads = _port_loss_and_grads(method, "float32", x1, cond, lengths,
                                       rng, kw)
    _close(got, want, 1e-5)
    assert set(pgrads) == set(wgrads)
    for k, g in pgrads.items():
        w = np.asarray(wgrads[k])
        if not np.any(w):  # a leaf the loss does not reach: zero in both
            assert g is None or not torch.any(g), k
            continue
        gain = k.endswith(("q_norm.gamma", "k_norm.gamma"))
        err = _rel_l2(g.numpy(), w)
        assert err <= (GAIN_TOL if gain else 1e-5), (k, err)
    keys = [k for k in pgrads if pgrads[k] is not None]
    assert _rel_l2(np.concatenate([pgrads[k].numpy().ravel() for k in keys]),
                   np.concatenate([np.asarray(wgrads[k]).ravel()
                                   for k in keys])) <= 1e-5


def test_training_loss_bf16_amp_matches_jax():
    """Both packages' fields computing in bf16 at the JAX cast points, the
    mix path with every option: test_train.py's bf16 bounds (loss within
    2e-2, gradient cosine > 0.995), which the two meet by far (measured:
    loss rel 2.4e-6, cosine 1 - 2.5e-7; each package's bf16 against its
    own float32: loss rel 4.3e-5 (port) and 4.1e-5 (JAX), cosine 1 -
    4.1e-6 and 1 - 4.2e-6)."""
    kw = CASES["independent_cfm_mix"]
    x1, cond = _mels(3, kw["t"], 7)
    lengths = LENGTHS[kw["t"]]
    rng = jax.random.PRNGKey(11)
    want, wgrads = _jax_loss_and_grads("independent_cfm_mix", "bfloat16", x1,
                                       cond, lengths, rng, kw)
    got, pgrads = _port_loss_and_grads("independent_cfm_mix", "bfloat16", x1,
                                       cond, lengths, rng, kw)
    assert abs(got - want) / abs(want) < 2e-2
    gw = np.concatenate([np.asarray(wgrads[k], np.float64).ravel()
                         for k in sorted(wgrads)])
    gp = np.concatenate([pgrads[k].numpy().astype(np.float64).ravel()
                         for k in sorted(pgrads)])
    cos = gp @ gw / (np.linalg.norm(gp) * np.linalg.norm(gw))
    assert cos > 0.995, cos


# --- the wrapper's forward --------------------------------------------------------

VOCODER = dict(num_mels=256, upsample_initial_channel=16,
               upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
# per path: the wrapper's and forward's options, and whether x1 and cond
# arrive as audio at 16 kHz (resampled and encoded) or as mels
FORWARD = {
    "basic_cfm": dict(cond_drop_prob=0.5),
    "independent_cfm_adaptive": dict(sigma=1e-4, cond_freq_masking=True),
    "independent_cfm_constant": dict(sigma=1e-4, audio=True),
    "independent_cfm_mix": dict(cond_drop_prob=0.4, weighted_loss=True,
                                cond_freq_masking=True),
}


@pytest.fixture(scope="module")
def codecs():
    return (JaxMelVoco(JaxMelConfig(), JaxVocoderConfig(**VOCODER)),
            MelVoco(MelConfig(), VocoderConfig(**VOCODER), device="cpu"))


@pytest.mark.parametrize("method", METHODS)
def test_wrapper_forward_matches_jax(codecs, method):
    kw = dict(FORWARD[method])
    audio = kw.pop("audio", False)
    wrap = dict(sigma=kw.pop("sigma", 0.0),
                cond_drop_prob=kw.pop("cond_drop_prob", 0.0),
                cfm_method=method)
    jfh = JaxFLowHigh(audio_enc_dec=codecs[0], **FIELD)
    jfh.params = _jax_net()[1]
    pfh = FLowHigh(audio_enc_dec=codecs[1], params=jfh.params, device="cpu",
                   **FIELD)
    jw, pw = JaxWrapper(jfh, **wrap), ConditionalFlowMatcherWrapper(pfh, **wrap)
    gen = np.random.default_rng(8)
    if audio:  # 2.5 s at 16 kHz, the second item's valid frames cut
        x1 = (0.3 * gen.standard_normal((2, 40000))).astype(np.float32)
        cond, lengths = 0.5 * x1, np.array([250, 140])
    else:  # mels of unequal lengths: end-padded, with the JAX warning
        x1, cond = _mels(2, 230, 9)
        cond, lengths = cond[:, :210], np.array([230, 180])
    rng = jax.random.PRNGKey(12)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = float(jax.jit(lambda a, c, n, r: jw.forward(
            a, cond=c, cond_lengths=n, input_sampling_rate=16000, rng=r,
            **kw))(x1, cond, lengths, rng))
        t = 250 if audio else 230
        got = pw.forward(x1, cond=cond, cond_lengths=lengths,
                         input_sampling_rate=16000,
                         draws=jax_draws(rng, (2, t, 256)), **kw)
    assert sum("end-padding" in str(w.message) for w in caught) == (
        0 if audio else 2)
    _close(float(got.detach()), want, 1e-5)
    got.backward()  # a training loss: it reaches the parameters
    assert pfh.net.to_embed.weight.grad is not None


def test_forward_keeps_the_net_mode_and_needs_a_codec(codecs):
    pfh = FLowHigh(params=_jax_net()[1], device="cpu", **FIELD)
    x1, cond = _mels(1, 30, 10)
    with pytest.raises(ValueError, match="audio_enc_dec"):
        ConditionalFlowMatcherWrapper(pfh).forward(x1, cond=cond)
    pfh.audio_enc_dec = codecs[1]
    assert not pfh.net.training
    loss = ConditionalFlowMatcherWrapper(pfh).forward(x1, cond=cond)
    assert torch.isfinite(loss) and not pfh.net.training


# --- dropout ------------------------------------------------------------------------

DROP = dict(dim_in=16, dim=32, depth=2, heads=2, dim_head=8)


def _drop_net(**kw):
    torch.manual_seed(0)
    return VectorFieldNet(ModelConfig(**DROP, **kw))


def _field_inputs():
    gen = np.random.default_rng(13)
    x, cond = (torch.from_numpy(gen.standard_normal((2, 24, 16)).astype(
        np.float32)) for _ in range(2))
    return dict(times=torch.tensor([0.2, 0.7]), cond=cond), x


def test_dropout_is_off_in_eval_mode():
    kw, x = _field_inputs()
    with torch.no_grad():
        want = _drop_net().eval()(x, **kw)
        net = _drop_net(attn_dropout=0.3, ff_dropout=0.3).eval()
        np.testing.assert_array_equal(net(x, **kw).numpy(), want.numpy())
        net.train()
        assert not torch.equal(net(x, **kw), want)


def test_dropout_keep_share_and_scale():
    x = torch.ones(200_000)
    y = ptransformer.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75),
                               atol=0, rtol=0)
    assert not ptransformer.dropout(x, 1.0, None).any()


def test_dropout_masks_follow_the_generator():
    kw, x = _field_inputs()
    net = _drop_net(attn_dropout=0.2, ff_dropout=0.2).train()
    with torch.no_grad():
        a, b, c = (net(x, generator=torch.Generator().manual_seed(s), **kw)
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_flash_is_taken_only_without_active_dropout(monkeypatch):
    kw, x = _field_inputs()
    calls = []

    def counted(*args):
        calls.append(1)
        return flash_attn.flash_attention_plain(*args)

    monkeypatch.setattr(ptransformer, "flash_attention", counted)
    with torch.no_grad():
        _drop_net(attn_flash=True, attn_dropout=0.2).train()(x, **kw)
        assert not calls  # dropout in train mode: the dense path
        _drop_net(attn_flash=True, attn_dropout=0.2).eval()(x, **kw)
        _drop_net(attn_flash=True, ff_dropout=0.2).train()(x, **kw)
    assert len(calls) == 4  # one a layer


# --- kernel F's plain version under autograd -------------------------------------

def test_flash_plain_gradient_equals_dense_attention():
    """On the CPU kernel F's wrapper takes its plain version, which autograd
    differentiates (the JAX package trains on its einsum path off the
    TPU): its gradient equals dense attention's for every query row that
    has a valid key set (the masked rows' own semantics differ)."""
    gen = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(gen.standard_normal((2, 2, 140, 8)).astype(
        np.float64)).requires_grad_() for _ in range(3))
    mask = torch.arange(140)[None, :] < torch.tensor([140, 100])[:, None]
    w = torch.from_numpy(gen.standard_normal((2, 2, 140, 8)))
    rows = mask[:, None, :, None]  # the valid queries

    def grads(attn):
        out = attn(q, k, v)
        (torch.where(rows, out, 0.0) * w).sum().backward()
        got = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        return got

    flash = grads(lambda a, b, c: flash_attn.flash_attention(a, b, c, mask,
                                                             10.0))

    def dense(a, b, c):
        sim = (a @ b.transpose(-1, -2)) * 10.0
        sim = sim.masked_fill(~mask[:, None, None, :], float("-inf"))
        return sim.softmax(-1) @ c

    for g, d in zip(flash, grads(dense)):
        torch.testing.assert_close(g, d, atol=1e-12, rtol=1e-9)
