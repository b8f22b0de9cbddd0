"""The port's VectorFieldNet against the JAX package's, with the JAX params
carried across by flowhigh_tpu_torch.compat.jax_params, at a tiny config
(dim 64, depth 2, 2 x 16 heads) with a padding mask."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu.config import ModelConfig as JaxModelConfig
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu.models import forward_with_cond_scale as jax_cfg_forward
from flowhigh_tpu_torch.compat import seeded_init_, vector_field_state_from_jax
from flowhigh_tpu_torch.config import ModelConfig
from flowhigh_tpu_torch.models import VectorFieldNet, forward_with_cond_scale

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TINY = dict(dim_in=32, dim=64, depth=2, heads=2, dim_head=16)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxVectorFieldNet(JaxModelConfig(**TINY))
    x = jnp.zeros((1, 16, TINY["dim_in"]))
    params = jnet.init(jax.random.PRNGKey(0), x, times=jnp.zeros(()), cond=x)
    # flax init leaves the adaptive norms at identity and null_cond at zero;
    # perturb every leaf so each mapped weight matters in the comparison
    leaves, tree = jax.tree_util.tree_flatten(params)
    gen = np.random.default_rng(1)
    leaves = [np.asarray(leaf) + 0.05 * gen.standard_normal(leaf.shape).astype(
        np.float32) for leaf in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    net = VectorFieldNet(ModelConfig(**TINY)).eval()
    net.load_state_dict(vector_field_state_from_jax(params, ModelConfig(**TINY)))
    return jnet, params, net


def _inputs(rng, b=2, t=24):
    x = rng.standard_normal((b, t, TINY["dim_in"])).astype(np.float32)
    cond = rng.standard_normal((b, t, TINY["dim_in"])).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, t - 7:] = False  # item 1 is padded
    return x, cond, mask


def test_forward_matches_jax_with_mask(nets, rng):
    jnet, params, net = nets
    x, cond, mask = _inputs(rng)
    times = np.array([0.2, 0.7], np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), times=jnp.asarray(times),
                                 cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), times=torch.from_numpy(times),
                  cond=torch.from_numpy(cond), mask=torch.from_numpy(mask)).numpy()
    # same f32 math, other matmul/softmax summation orders
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cond_scale", [1.0, 2.5])
def test_forward_with_cond_scale_matches_jax(nets, rng, cond_scale):
    jnet, params, net = nets
    x, cond, mask = _inputs(rng)
    want = np.asarray(jax_cfg_forward(
        jnet.apply, params, jnp.asarray(x), times=jnp.asarray(0.4),
        cond=jnp.asarray(cond), cond_scale=cond_scale, mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = forward_with_cond_scale(
            net, torch.from_numpy(x), times=torch.tensor(0.4),
            cond=torch.from_numpy(cond), cond_scale=cond_scale,
            mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_layout_is_the_reference_layout():
    ref = torch_ref.TorchFLowHigh(dim_in=TINY["dim_in"], dim=TINY["dim"],
                                  depth=TINY["depth"], dim_head=TINY["dim_head"],
                                  heads=TINY["heads"])
    port = VectorFieldNet(ModelConfig(**TINY))
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    # so a reference state dict loads with no second mapping
    port.load_state_dict(ref.state_dict())


def test_seeded_init_is_deterministic_and_keeps_proper_1d_inits():
    a = seeded_init_(VectorFieldNet(ModelConfig(**TINY)), 7).state_dict()
    b = seeded_init_(VectorFieldNet(ModelConfig(**TINY)), 7).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert torch.all(a["transformer.final_norm.gamma"] == 1)
    assert torch.all(a["transformer.layers.0.3.q_norm.gamma"] == 1)
    assert torch.all(a["transformer.layers.0.2.to_gamma.bias"] == 1)
    assert torch.all(a["transformer.layers.0.2.to_beta.bias"] == 0)
    assert torch.all(a["null_cond"] == 0)
    w = a["transformer.layers.0.5.0.weight"]  # [out, in]: std 1/sqrt(in)
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.05
