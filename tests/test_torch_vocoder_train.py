"""The port's vocoder GAN trainer (``flowhigh_tpu_torch.train
.VocoderTrainer``) and its kernels' gradients against the JAX package on
the CPU, mirroring tests/test_train.py's ``TestVocoderTrainer``.

The tiny configuration is that file's: 16 channels, rates (8, 5, 4, 3),
8-frame segments, one period (2) and one resolution (512, 50, 240). Both
packages start from the port's seeded weights, carried into the JAX trees
by the JAX package's own importers (``map_vocoder_state_dict`` of the
port's ``g_`` export, ``map_mpd_state_dict``, ``map_mrd_state_dict``). The
JAX side compiles twice: one ``jax.jit`` of the two GAN losses and their
gradients from the package's public functions, and the JAX
``VocoderTrainer``'s own step.

On the CPU the kernel wrappers take their plain versions, so the trainer
here differentiates the plain generator, as the JAX trainer does. The
``torch.autograd.Function``s that carry kernels A, B and C's gradients on
the card are run here with their launches replaced by the plain versions:
their backward passes then equal autograd of the plain versions bit for
bit.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu.compat import (map_mpd_state_dict, map_mrd_state_dict,
                                 map_vocoder_state_dict,
                                 vocoder_params_to_torch_state)
from flowhigh_tpu.config import MelConfig as JaxMelConfig
from flowhigh_tpu.config import VocoderConfig as JaxVocoderConfig
from flowhigh_tpu.models import BigVGAN as JaxBigVGAN
from flowhigh_tpu.models import discriminators as jd
from flowhigh_tpu.models.melvoco import encode as jax_encode
from flowhigh_tpu.ops.fused_act import fused_snake_activation1d
from flowhigh_tpu.parallel import make_mesh
from flowhigh_tpu.train import VocoderTrainer as JaxVocoderTrainer
from flowhigh_tpu.train.vocoder_trainer import (
    VocoderTrainState as JaxVocoderTrainState)
from flowhigh_tpu_torch.compat import (mpd_state_from_jax, mrd_state_from_jax,
                                       vocoder_state_from_jax,
                                       vocoder_state_to_reference)
from flowhigh_tpu_torch.config import VocoderConfig
from flowhigh_tpu_torch.ops import conv, fused_act
from flowhigh_tpu_torch.train import VocoderTrainer, VocoderTrainState

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TINY = dict(num_mels=256, upsample_initial_channel=16,
            upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
KW = dict(segment_frames=8, periods=(2,), resolutions=((512, 50, 240),))
ULP = 2.0 ** -23  # one float32 ulp, relative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and torch's pool then spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_trainer(tmp=None, **kw) -> VocoderTrainer:
    return VocoderTrainer(VocoderConfig(**TINY), device="cpu",
                          results_folder=str(tmp or "unused"), **KW, **kw)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def make_batch() -> dict:
    """Two 8-frame segments of noise at 0.3."""
    rng = np.random.default_rng(0)
    n = KW["segment_frames"] * JaxMelConfig().hop_length
    return {"wave": (rng.standard_normal((2, n)) * 0.3).astype(np.float32)}


def make_params() -> dict:
    """The port's seeded weights as the JAX package's trees."""
    s = port_trainer().init_state(0)
    jcfg = JaxVocoderConfig(**TINY)
    gen = map_vocoder_state_dict(vocoder_state_to_reference(
        s.generator.state_dict(), s.generator.cfg), jcfg)
    return jax.device_get({
        "gen": gen, "mpd": map_mpd_state_dict(s.mpd.state_dict(),
                                              KW["periods"]),
        "mrd": map_mrd_state_dict(s.mrd.state_dict(), KW["resolutions"])})


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def params():
    return make_params()


def port_leaves(state: VocoderTrainState, params_or_grads) -> dict:
    """{name: (port tensor, JAX value in the port's layout)} over the three
    modules, from a {"gen", "mpd", "mrd"} tree of JAX values."""
    want = {"generator": vocoder_state_from_jax(params_or_grads["gen"],
                                                state.generator.cfg),
            "mpd": mpd_state_from_jax(params_or_grads["mpd"], KW["periods"]),
            "mrd": mrd_state_from_jax(params_or_grads["mrd"],
                                      KW["resolutions"])}
    return {f"{m}.{n}": (p, want[m][n]) for m in want
            for n, p in getattr(state, m).named_parameters()}


# --- the two GAN losses and their gradients -----------------------------------------

@pytest.fixture(scope="module")
def jax_grads(params, batch):
    """The JAX trainer's two losses written from the package's public
    functions, and their gradients, on ``batch`` and on it nudged by one
    ulp up and down (the same compiled function)."""
    jcfg, mel_cfg = JaxVocoderConfig(**TINY), JaxMelConfig()
    gen = JaxBigVGAN(jcfg)
    mpd = jd.MultiPeriodDiscriminator(periods=KW["periods"])
    mrd = jd.MultiResolutionDiscriminator(resolutions=KW["resolutions"])

    def disc_loss(dp, gp, wav, mel):
        fake = jax.lax.stop_gradient(gen.apply(gp, mel)[:, :wav.shape[1]])
        return (jd.discriminator_loss(*mpd.apply(dp["mpd"], wav, fake)[:2])[0]
                + jd.discriminator_loss(*mrd.apply(dp["mrd"], wav,
                                                   fake)[:2])[0])

    def gen_loss(gp, dp, wav, mel):
        fake = gen.apply(gp, mel)[:, :wav.shape[1]]
        _, o_g, f_r, f_g = mpd.apply(dp["mpd"], wav, fake)
        _, o_g2, f_r2, f_g2 = mrd.apply(dp["mrd"], wav, fake)
        l_mel = jnp.mean(jnp.abs(jax_encode(fake, mel_cfg)
                                 - jax_encode(wav, mel_cfg))) * 45.0
        return (jd.generator_loss(o_g)[0] + jd.generator_loss(o_g2)[0]
                + jd.feature_loss(f_r, f_g) + jd.feature_loss(f_r2, f_g2)
                + l_mel)

    @jax.jit
    def both(p, wav):
        dp = {"mpd": p["mpd"], "mrd": p["mrd"]}
        mel = jax_encode(wav, mel_cfg)[:, :KW["segment_frames"]]
        d, dg = jax.value_and_grad(disc_loss)(dp, p["gen"], wav, mel)
        g, gg = jax.value_and_grad(gen_loss)(p["gen"], dp, wav, mel)
        return d, g, {"gen": gg, **dg}

    return {s: jax.device_get(both(params, jnp.asarray(
        batch["wave"] * np.float32(1 + s)))) for s in (0.0, ULP, -ULP)}


@pytest.fixture(scope="module")
def port_grads(params, batch):
    """The port trainer's two losses and every parameter's gradient, at
    the same weights (the discriminators not yet updated)."""
    tr = port_trainer()
    s = tr.init_state(params=params)
    wav, mel_real = tr.segments(batch)
    fake = s.generator(mel_real[:, :KW["segment_frames"]].contiguous())[
        :, :wav.shape[1]]
    d = tr.disc_loss(s.mpd, s.mrd, wav, fake.detach())
    d.backward()
    g, _ = tr.gen_loss(s.mpd, s.mrd, wav, fake, mel_real)
    s.generator.zero_grad()
    g.backward(inputs=list(s.generator.parameters()))
    return s, d.item(), g.item()


def test_gan_losses_match_jax(jax_grads, port_grads):
    _, d, g = port_grads
    jd_, jg, _ = jax_grads[0.0]
    assert abs(d - float(jd_)) <= 1e-5 * abs(float(jd_))
    assert abs(g - float(jg)) <= 1e-5 * abs(float(jg))


def test_gan_gradients_match_jax(jax_grads, port_grads):
    """Every leaf's gradient against ``jax.grad``: the MPD's within rel L2
    1e-5 (measured: 1.2e-6 at most). Named looser: every MRD and generator
    leaf. Their gradients are ill-conditioned at float32: a one-ulp nudge
    of the waveform moves the JAX package's own gradients by 1e-4 (the
    generator's, flat) and up to 1.5e-3 a leaf (leaky-ReLU and |.| branch
    flips of values within rounding of 0, and the mel term's float32
    magnitudes of quiet bins, which the port takes in float64). So those
    leaves are held to twice the larger of the two nudges' flat change, and
    each leaf to 5e-3 (measured: generator flat 1.1e-4 against the nudge's
    1.0e-4, the worst leaf 7.3e-4; MRD 1.1e-4 against 2.1e-4)."""
    state = port_grads[0]
    leaves = port_leaves(state, jax_grads[0.0][2])
    nudged = [port_leaves(state, jax_grads[s][2]) for s in (ULP, -ULP)]
    loose = {"generator": ([], [], []), "mrd": ([], [], [])}
    for name, (p, want) in leaves.items():
        got, want = p.grad.numpy(), want.numpy()
        rel = rel_l2(got, want)
        part = name.split(".")[0]
        if part == "mpd":
            assert rel <= 1e-5, (name, rel)
            continue
        assert rel <= 5e-3, (name, rel)
        flat_got, flat_want, flat_nudge = loose[part]
        flat_got.append(got.ravel())
        flat_want.append(want.ravel())
        flat_nudge.append([n[name][1].numpy().ravel() for n in nudged])
    for part, (got, want, nudge) in loose.items():
        want = np.concatenate(want)
        floor = max(rel_l2(np.concatenate([n[i] for n in nudge]), want)
                    for i in range(2))
        rel = rel_l2(np.concatenate(got), want)
        assert 0 < floor and rel <= 2 * floor, (part, rel, floor)


# --- the optimizers and the kernels' weight caches -----------------------------

def test_adam_moves_the_weight_caches_key(batch):
    """Kernels B and C read their weights through a layout cached by the
    tensor's version counter: every optimizer step must bump it (the
    trainer's foreach Adams do)."""
    tr = port_trainer()
    s = tr.init_state(0)
    params = list(s.generator.parameters()) + list(s.mpd.parameters())
    before = [p._version for p in params]
    tr.train_step(s, batch)
    assert all(p._version > v for p, v in zip(params, before))


# --- checkpoints and the loop ----------------------------------------------------

def _state_tensors(state: VocoderTrainState) -> dict:
    out = {f"{m}.{k}": v for m in ("generator", "mpd", "mrd")
           for k, v in getattr(state, m).state_dict().items()}
    for o in ("gen_optimizer", "disc_optimizer"):
        for i, st in getattr(state, o).state_dict()["state"].items():
            out.update({f"{o}.{i}.{k}": v for k, v in st.items()})
    return out


def test_kill_and_resume_bit_identical(batch, tmp_path):
    """``fit`` saves the whole GAN state (the three modules, both Adams,
    the step) and a killed run resumes bit for bit, the mirror of
    tests/test_train.py's test."""
    it = iter(lambda: batch, None)
    quiet = dict(log_every=100, log_fn=lambda *_: None)
    ref = port_trainer(tmp_path / "a").fit(it, num_steps=3, **quiet)
    port_trainer(tmp_path / "b").fit(it, num_steps=2, save_every=2, **quiet)
    assert (tmp_path / "b" / "vocoder_state_2.pt").exists()
    assert (tmp_path / "b" / "g_00000002").exists()
    logs = []
    res = port_trainer(tmp_path / "b").fit(it, num_steps=3, auto_resume=True,
                                    log_every=100, log_fn=logs.append)
    assert any("auto-resuming" in str(line) for line in logs)
    assert res.step == 3
    a, b = _state_tensors(ref), _state_tensors(res)
    assert a.keys() == b.keys() and len(a) > 100
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fit_logs_the_jax_line(batch, tmp_path):
    logs = []
    state = port_trainer(tmp_path).fit(iter(lambda: batch, None), num_steps=2,
                                log_every=1, log_fn=logs.append)
    assert state.step == 2 and len(logs) == 2
    for i, line in enumerate(logs):
        assert re.fullmatch(
            rf"\[vocoder\] step {i + 1} disc=\d+\.\d{{3}} gen=\d+\.\d{{3}} "
            rf"mel_l1=\d+\.\d{{3}} \(\d+\.\d{{2}} it/s\)", line), line


def test_generator_package_equals_the_jax_export(params, tmp_path):
    """The ``g_`` package is the JAX package's ``vocoder_params_to_torch_
    state`` of the same weights, bit for bit, and loads into the
    reference's weight-normed generator (tests/torch_ref.py), which then
    gives the port's waveform."""
    tr = port_trainer(tmp_path)
    state = tr.init_state(params=params)
    tr.save(state)
    pkg = torch.load(tmp_path / "g_00000000", map_location="cpu",
                     weights_only=True)["generator"]
    want = vocoder_params_to_torch_state(params["gen"], JaxVocoderConfig(
        **TINY))
    assert pkg.keys() == want.keys()
    for k in pkg:
        assert pkg[k].dtype == torch.float32
        torch.testing.assert_close(pkg[k], want[k], rtol=0, atol=0)
    ref = torch_ref.TorchBigVGAN(tr.voc_cfg)
    sd = ({k.replace("weight_g", "parametrizations.weight.original0")
           .replace("weight_v", "parametrizations.weight.original1"): v
           for k, v in pkg.items()}
          if any("parametrizations" in k for k in ref.state_dict()) else pkg)
    _, unexpected = ref.load_state_dict(sd, strict=False)
    assert not unexpected
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 8, 256)).astype(np.float32))
    with torch.no_grad():
        got = state.generator(mel)
        want_wav = ref.eval()(mel.transpose(1, 2))[:, 0]
    torch.testing.assert_close(got, want_wav, rtol=0, atol=2e-4)


def test_refuses_a_mesh_and_an_orbax_directory(tmp_path):
    # a mesh is taken (one process: no collective; several:
    # tests/test_torch_parallel.py); an orbax directory is refused
    from flowhigh_tpu_torch.parallel import make_mesh as port_make_mesh
    assert port_trainer(mesh=port_make_mesh()).init_state(0).ddp is None
    tr = port_trainer(tmp_path)
    (tmp_path / "orbax_2").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tr.restore_state(tmp_path / "orbax_2", tr.init_state(0))


# --- kernels A, B and C's gradients -------------------------------------------------

@pytest.fixture
def launches_as_plain(monkeypatch):
    """The three kernels' launches replaced by their plain versions, so
    their ``autograd.Function``s run here."""
    monkeypatch.setattr(conv, "_launch_conv1d", lambda x, w, b, d, res, s, *_:
                        conv.conv1d_plain(x, w, b, dilation=d, residuals=res,
                                          out_scale=s))
    monkeypatch.setattr(conv, "_launch_conv_transpose1d",
                        lambda x, w, b, u, _: conv.conv_transpose1d_plain(
                            x, w, b, stride=u))
    monkeypatch.setattr(fused_act, "_launch_snake", lambda x, a, b, log, _:
                        fused_act.snake_activation1d_plain(x, a, b, log))


def _grads(fn, tensors, need, g):
    leaves = [t.clone().requires_grad_(n) for t, n in zip(tensors, need)]
    fn(*leaves).backward(g)
    return [t.grad for t in leaves]


def _same_grads(function_call, plain_call, tensors, need, out_shape):
    gen = torch.Generator().manual_seed(4)
    g = torch.randn(out_shape, generator=gen)
    for a, b in zip(_grads(function_call, tensors, need, g),
                    _grads(plain_call, tensors, need, g)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_res,out_scale,bias,need", [
    (0, 1.0, True, (True, True, True)), (1, 1.0, False, (True, True, True)),
    (3, 1 / 3, True, (True, True, True, True, True, True)),
    (2, 0.5, True, (False, True, False, True, False))])
def test_kernel_b_function_is_the_plain_vjp(launches_as_plain, n_res,
                                            out_scale, bias, need):
    gen = torch.Generator().manual_seed(1)
    x, w = torch.randn(2, 8, 40, generator=gen), torch.randn(8, 8, 3,
                                                              generator=gen)
    res = [torch.randn(2, 8, 40, generator=gen) for _ in range(n_res)]
    b = [torch.randn(8, generator=gen)] if bias else []
    tensors = [x, w] + b + res

    def split(args):
        return args[0], args[1], (args[2] if bias else None), \
            args[2 + bias:]

    def function_call(*args):
        x, w, b, r = split(args)
        return conv._Conv1dGrad.apply(x, w, b, 3, out_scale, *r)

    def plain_call(*args):
        x, w, b, r = split(args)
        return conv.conv1d_plain(x, w, b, dilation=3, residuals=r,
                                 out_scale=out_scale)
    _same_grads(function_call, plain_call, tensors, need, (2, 8, 40))


@pytest.mark.parametrize("stride,k", [(4, 8), (2, 4), (8, 16)])
def test_kernel_c_function_is_the_plain_vjp(launches_as_plain, stride, k):
    gen = torch.Generator().manual_seed(2)
    tensors = [torch.randn(2, 16, 10, generator=gen),
               torch.randn(16, 8, k, generator=gen), torch.randn(
                   8, generator=gen)]
    _same_grads(lambda x, w, b: conv._ConvT1dGrad.apply(x, w, b, stride),
                lambda x, w, b: conv.conv_transpose1d_plain(x, w, b,
                                                            stride=stride),
                tensors, (True, True, True), (2, 8, 10 * stride))


@pytest.mark.parametrize("beta", [True, False])
def test_kernel_a_function_is_the_plain_vjp(launches_as_plain, beta):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 40, generator=gen)
    ab = [torch.randn(8, generator=gen) * 0.3 for _ in range(1 + beta)]
    fa = fused_act.snake_activation1d_plain

    def function_call(x, a, b=None):
        return fused_act._SnakeGrad.apply(x, a, b, True)

    def plain_call(x, a, b=None):
        return fa(x, a, b, True)
    _same_grads(function_call, plain_call, [x] + ab, [True] * (2 + beta),
                (2, 8, 40))


def test_plain_snake_gradient_matches_jax_custom_vjp():
    """The plain snake's autograd (kernel A's backward) against ``jax.grad``
    of the JAX package's ``fused_snake_activation1d`` (its custom VJP, the
    Pallas kernel in interpret mode) at C = 64, T = 64: dx, dalpha, dbeta
    within rel L2 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    a, b = (rng.standard_normal(64).astype(np.float32) * 0.3
            for _ in range(2))
    g = rng.standard_normal((2, 64, 64)).astype(np.float32)

    def loss(x, a, b):  # JAX's layout [B, T, C]
        y = fused_snake_activation1d(x, a, b, True, True)
        return jnp.sum(y * jnp.asarray(g.transpose(0, 2, 1)))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(a), jnp.asarray(b))
    got = _grads(lambda x, a, b: fused_act.snake_activation1d_plain(
        x, a, b, True), [torch.from_numpy(v) for v in (x, a, b)],
        (True, True, True), torch.from_numpy(g))
    assert rel_l2(got[0].numpy(), np.asarray(want[0]).transpose(0, 2, 1)) \
        <= 1e-5
    for p, w in zip(got[1:], want[1:]):
        assert rel_l2(p.numpy(), np.asarray(w)) <= 1e-5


def test_refusal_names_the_jax_error():
    err = conv.no_grad_error("act_conv1d", "kernel D")
    assert isinstance(err, ValueError)
    assert "Linearization failed to produce known values" in str(err)
    with pytest.raises(ValueError, match="bf16-dot, float32-map"):
        conv._check_grad_instance("conv1d", torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="bfloat16-map"):
        conv._check_grad_instance("snake_activation1d", torch.float32,
                                  torch.bfloat16)
    conv._check_grad_instance("conv1d", torch.float32, torch.float32)


def test_generator_export_checks_the_config(params):
    state = port_trainer().init_state(params=params)
    sd = state.generator.state_dict()
    assert vocoder_state_to_reference(sd, state.generator.cfg)
    with pytest.raises(ValueError, match="resblocks"):
        vocoder_state_to_reference(sd, VocoderConfig(**{
            **TINY, "resblock_kernel_sizes": (3, 7),
            "resblock_dilation_sizes": ((1, 3), (1, 3))}))


def test_train_step_after_inference_mode(batch, monkeypatch):
    """A device constant (the mel basis) first copied under
    ``torch.inference_mode`` (as serving does) is an ordinary tensor, so
    a later GAN step can save it for its backward."""
    from flowhigh_tpu_torch import utils
    from flowhigh_tpu_torch.models import mel_encode
    monkeypatch.setattr(utils, "_constants", {})
    with torch.inference_mode():
        mel_encode(torch.from_numpy(batch["wave"]))
    tr = port_trainer()
    state, m = tr.train_step(tr.init_state(0), batch)
    assert all(torch.isfinite(v) for v in m.values())
