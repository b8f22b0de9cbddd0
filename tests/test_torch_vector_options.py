"""The vector field's options in the port against the JAX package on the
CPU (mirroring tests/test_transformer_features.py but for dropout, the
optimizer order and the training loss): register tokens, U-Net skips and
GateLoop layers, alone and together, the ConvNeXt backbone and
``compute_dtype="bfloat16"``, at a tiny config with a key-padding mask;
GateLoop's doubling scan; reference-layout checkpoints through
``from_local``; ``generate`` with the options."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu.compat.torch_ckpt import params_to_torch_state
from flowhigh_tpu.config import ModelConfig as JaxModelConfig
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu.models import forward_with_cond_scale as jax_cfg_forward
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch.compat import seeded_init_, vector_field_state_from_jax
from flowhigh_tpu_torch.config import ModelConfig, VocoderConfig
from flowhigh_tpu_torch.models import (GateLoop, VectorFieldNet,
                                       forward_with_cond_scale)
from flowhigh_tpu_torch.models.transformer import linear_scan
from test_torch_serving import FILE_VOCODER
from test_torch_sr import TINY_VOCODER, _configs, _perturbed_1d

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TINY = dict(dim_in=8, dim=16, depth=2, heads=2, dim_head=4)
OPTIONS = {
    "registers": dict(num_register_tokens=3),
    "skips": dict(use_unet_skip_connection=True),
    "gateloop": dict(use_gateloop_layers=True),
    "all": dict(num_register_tokens=3, use_unet_skip_connection=True,
                skip_connect_scale=0.5, use_gateloop_layers=True),
    "convnext": dict(architecture="convnext"),
}


def _field_params(jnet, seed=0):
    """JAX params of ``jnet`` without compiling its init (``_fast_init``:
    fan-in normals, 1-D leaves zeroed), every 1-D leaf then set to
    1 + N(0, 0.1) so that each norm gain, bias and ``null_cond`` shows."""
    x = jnp.zeros((1, 12, jnet.cfg.dim_in))
    params = jax.device_get(_fast_init(
        lambda r: jnet.init(r, x, times=jnp.zeros(()), cond=x),
        jax.random.PRNGKey(seed)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    gen = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(v) if v.ndim > 1 else
        (1.0 + 0.1 * gen.standard_normal(v.shape)).astype(np.float32)
        for v in leaves])


@pytest.fixture(scope="module")
def pairs():
    """{option set: (jitted JAX apply, JAX params, port net)}, built once
    per option set on first use."""
    cache = {}

    def get(name, **extra):
        key = (name,) + tuple(sorted(extra.items()))
        if key not in cache:
            opts = {**TINY, **OPTIONS.get(name, {}), **extra}
            jnet = JaxVectorFieldNet(JaxModelConfig(**opts))
            params = _field_params(jnet)
            cfg = ModelConfig(**opts)
            net = VectorFieldNet(cfg).eval()
            net.load_state_dict(vector_field_state_from_jax(params, cfg))
            cache[key] = (jax.jit(jnet.apply), params, net)
        return cache[key]
    return get


def _inputs(b=2, t=12, seed=0):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((b, t, TINY["dim_in"])).astype(np.float32)
               for _ in range(2))
    mask = np.ones((b, t), bool)
    mask[1, t - 4:] = False  # item 1 is padded
    return x, cond, mask


def _run_both(pair, cond_scale, x, cond, mask, times=0.4):
    apply, params, net = pair
    want = np.asarray(jax_cfg_forward(
        apply, params, jnp.asarray(x), times=jnp.asarray(times),
        cond=jnp.asarray(cond), cond_scale=cond_scale,
        mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = forward_with_cond_scale(
            net, torch.from_numpy(x), times=torch.tensor(times),
            cond=torch.from_numpy(cond), cond_scale=cond_scale,
            mask=torch.from_numpy(mask)).float().numpy()
    return got, want


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_options_match_jax(pairs, name, cond_scale):
    got, want = _run_both(pairs(name), cond_scale, *_inputs())
    assert got.shape == want.shape == (2, 12, TINY["dim_in"])
    # tests/test_torch_vector_field.py's bound: the same f32 math in other
    # summation orders
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_registers_with_flash_on_the_cpu(pairs):
    # the JAX package falls back to its dense path off the TPU; the port
    # runs kernel F's plain version on the register-padded q, k, v and
    # mask. Masked rows follow F's pad-segment rule, so compare valid frames
    x, cond, mask = _inputs(seed=1)
    apply, params, _ = pairs("registers")
    cfg = ModelConfig(**TINY, **OPTIONS["registers"], attn_flash=True)
    net = VectorFieldNet(cfg).eval()
    net.load_state_dict(vector_field_state_from_jax(params, cfg))
    got, want = _run_both((apply, params, net), 1.0, x, cond, mask)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-4, rtol=1e-4)


def _sequential_scan(a, b):
    s, acc = np.zeros_like(b), np.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        acc = a[:, t] * acc + b[:, t]
        s[:, t] = acc
    return s


@pytest.mark.parametrize("t", [1, 6, 37])
def test_doubling_scan_matches_loop_and_associative_scan(t):
    rng = np.random.default_rng(t)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((2, t, 3))))).astype(
        np.float32)
    b = rng.standard_normal((2, t, 3)).astype(np.float32)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a, b), axis=1))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got, _sequential_scan(a, b), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gateloop_is_causal():
    gl = seeded_init_(GateLoop(16), 0).eval()
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 10, 16)).astype(np.float32))
    h2 = h.clone()
    h2[:, 7:] = 0.0  # change the future
    with torch.no_grad():
        torch.testing.assert_close(gl(h)[:, :7], gl(h2)[:, :7], rtol=1e-6,
                                   atol=1e-7)


def test_odd_depth_with_skips_is_refused():
    opts = dict(TINY, depth=3, use_unet_skip_connection=True)
    with pytest.raises(ValueError, match="even depth"):
        VectorFieldNet(ModelConfig(**opts))
    x = jnp.zeros((1, 4, 8))
    with pytest.raises(AssertionError):  # the JAX package asserts it
        jax.eval_shape(lambda r: JaxVectorFieldNet(JaxModelConfig(**opts)).init(
            r, x, times=jnp.zeros((1,)), cond=x), jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", ["all", "convnext"])
def test_state_dict_layout_is_the_reference_layout(name):
    # tests/torch_ref.py has register tokens, skips and ConvNeXt (no
    # GateLoop: the reference's comes from an external package)
    opts = {**TINY, **OPTIONS[name]}
    ref = torch_ref.TorchFLowHigh(
        **{k: opts[k] for k in ("dim_in", "dim", "depth", "dim_head",
                                "heads")},
        num_register_tokens=opts.get("num_register_tokens", 0),
        use_unet_skip_connection=opts.get("use_unet_skip_connection", False),
        architecture=opts.get("architecture", "transformer"))
    port = VectorFieldNet(ModelConfig(**dict(opts, use_gateloop_layers=False)))
    assert ({k: tuple(v.shape) for k, v in port.state_dict().items()}
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()})


def test_seeded_init_covers_the_new_parameters():
    a = seeded_init_(VectorFieldNet(ModelConfig(**TINY, **OPTIONS["all"])), 5)
    b = seeded_init_(VectorFieldNet(ModelConfig(**TINY, **OPTIONS["all"])), 5)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    reg = a.transformer.register_tokens.detach()
    assert 0.5 < float(reg.std()) < 1.5  # unit normals
    gl = a.transformer.layers[0][1]
    assert torch.all(gl.post_ln.weight == 1) and torch.all(gl.norm.gamma == 1)
    assert torch.all(a.transformer.layers[1][0].bias == 0)
    c = seeded_init_(VectorFieldNet(ModelConfig(**TINY, **OPTIONS["convnext"])),
                     5)
    blk = c.convnext[0]
    assert torch.all(blk.gamma == 1) and torch.all(blk.norm.scale.bias == 1)
    assert torch.all(blk.norm.shift.bias == 0)
    assert torch.all(c.final_layer_norm.weight == 1)


# --- compute_dtype="bfloat16" ----------------------------------------------------

def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_declared_casts(pair, x, cond, mask, times=0.4):
    """The JAX net compiled without XLA's excess precision
    (``xla_allow_excess_precision``), so that it rounds at every cast its
    program states: by default XLA on the CPU keeps some bf16 values in
    f32 where a cast to bf16 is followed by one back."""
    apply, params, _ = pair
    args = (params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    fn = jax.jit(lambda p, x, c, m: apply(p, x, times=jnp.asarray(times),
                                          cond=c, mask=m))
    return np.asarray(fn.lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args))


@pytest.mark.parametrize("name", ["skips", "all", "convnext"])
def test_bf16_compute_follows_the_jax_cast_points(pairs, name):
    x, cond, mask = _inputs(seed=2)
    f32 = _run_both(pairs(name), 1.0, x, cond, mask)[1]
    pair = pairs(name, compute_dtype="bfloat16")
    got = _run_both(pair, 1.0, x, cond, mask)[0]
    want = _jax_declared_casts(pair, x, cond, mask)
    # bf16 roundings at the same points, other f32 summation orders inside
    # the products: the port lands near the JAX bf16 output, much nearer
    # than to the f32 one (bf16 moves this output by 0.8-4% rel L2)
    assert _rel(got, want) <= 2e-2, _rel(got, want)
    assert 2 * _rel(got, want) <= _rel(got, f32), (_rel(got, want),
                                                   _rel(got, f32))


# --- reference-layout checkpoints -------------------------------------------------

def _checkpoint_dir(path, state: dict):
    """A reference checkpoint directory: the vector field's ``state`` as
    the model file and a seeded reference vocoder."""
    torch.manual_seed(0)
    voc = torch_ref.TorchBigVGAN(VocoderConfig(**FILE_VOCODER)).eval()
    torch.save({"generator": torch_ref.torch_state_dict_weight_normed(voc)},
               path / "bigvgan_48khz_256band.pt")
    (path / "bigvgan_48khz_256band.json").write_text(json.dumps(
        {**FILE_VOCODER, "upsample_rates": list(FILE_VOCODER["upsample_rates"]),
         "resblock_dilation_sizes": [list(d) for d in FILE_VOCODER[
             "resblock_dilation_sizes"]],
         "resblock": "1", "activation": "snakebeta", "snake_logscale": True}))
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in state.items()}},
               path / "FLowHigh_basic_400k.pt")
    return path


@pytest.mark.parametrize("name", ["registers", "skips", "convnext"])
def test_reference_checkpoint_loads_through_from_local(pairs, tmp_path, name):
    apply, params, _ = pairs(name)
    opts = {**TINY, **OPTIONS[name]}
    state = params_to_torch_state(params, JaxModelConfig(**opts))
    sr = FlowHighSR.from_local(_checkpoint_dir(tmp_path, state),
                               model_config=ModelConfig(**opts), device="cpu")
    x, cond, mask = _inputs(seed=3)
    got, want = _run_both((apply, params, sr.net), 1.0, x, cond, mask)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_gateloop_checkpoint_is_refused(pairs, tmp_path):
    _, params, _ = pairs("skips")
    state = params_to_torch_state(params, JaxModelConfig(
        **TINY, **OPTIONS["skips"]))
    state["flowhigh.transformer.layers.0.1.to_qkva.weight"] = np.zeros(
        (64, 16), np.float32)
    with pytest.raises(NotImplementedError, match="gateloop_transformer"):
        FlowHighSR.from_local(_checkpoint_dir(tmp_path, state),
                              model_config=ModelConfig(**TINY, **OPTIONS[
                                  "all"]), device="cpu")


# --- generate -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["all", "convnext"])
def test_generate_matches_jax(name):
    model = dict(TINY, dim_in=256, **OPTIONS[name])
    cj, cp = _configs(model, TINY_VOCODER)
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler")
    jsr.params = _field_params(jsr.net, 3)
    jsr.melvoco.vocoder_params = _perturbed_1d(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, jnp.zeros((1, 4, 256))),
        jax.random.PRNGKey(4)), 5, 0.1)
    psr = FlowHighSR(cp, jsr.params, jsr.melvoco.vocoder_params,
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    audio = (np.random.default_rng(5).standard_normal(8000) * 0.3).astype(
        np.float32)
    want = jsr.generate(audio, 16000, timestep=1)
    got = psr.generate(audio, 16000, timestep=1)
    assert got.shape == want.shape == (1, 24000)
    # tests/test_torch_sr.py's generate bound
    np.testing.assert_allclose(got, want, atol=1e-3)
