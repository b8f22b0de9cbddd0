"""Kernel F's plain version (``flowhigh_tpu_torch.ops.flash_attention_plain``)
and the modules around it against the JAX package's ``_flash_attention``,
run as the JAX package's own tests run it on the CPU: the Pallas kernel in
TPU-interpret mode (``transformer.FLASH_INTERPRET``, set inside each test
and restored). Every row is compared, masked rows included: the JAX
function pads N with segment-0 keys that masked queries also attend to."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowhigh_tpu.models.transformer as JT
from flowhigh_tpu.config import ModelConfig as JaxModelConfig
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat import seeded_init_, vector_field_state_from_jax
from flowhigh_tpu_torch.config import ModelConfig
from flowhigh_tpu_torch.models import VectorFieldNet
from flowhigh_tpu_torch.models.transformer import Attention, rotary_freqs
from flowhigh_tpu_torch.ops.flash_attn import flash_block, flash_pad

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SCALE = 10.0  # the model's qk-norm scale: sharp logits


@contextlib.contextmanager
def interpret():
    JT.FLASH_INTERPRET = True
    try:
        yield
    finally:
        JT.FLASH_INTERPRET = False


def _qkv(seed, b, h, n, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, dh)).astype(np.float32)
                 for _ in range(3))


def _mask(n, valids):
    return None if valids is None else np.arange(n)[None, :] < np.array(
        valids)[:, None]


def _jax_flash(q, k, v, mask, scale=SCALE):
    with interpret():
        return np.asarray(JT._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask), scale))


def _plain(q, k, v, mask, scale=SCALE):
    return ops.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), scale).numpy()


def _assert_bounds(got, want, n):
    """The JAX package's bounds (tests/test_transformer_features.py):
    atol 1e-4 within one block, max 5e-3 and mean 1e-4 over several."""
    d = np.abs(got - want)
    if flash_block(n) >= n:
        assert d.max() <= 1e-4, d.max()
    else:
        assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())


def test_block_and_pad_follow_the_jax_function():
    # blk = min(512, max(128, ceil(n / 128) * 128)), n_pad a multiple of it
    assert [flash_block(n) for n in (1, 128, 129, 257, 640, 30000)] == [
        128, 128, 256, 384, 512, 512]
    assert [flash_pad(n) for n in (128, 248, 257, 640, 700, 30000)] == [
        0, 8, 127, 384, 324, 208]


@pytest.mark.parametrize("dh", [16, 32])
@pytest.mark.parametrize("n,valids", [(128, None), (128, (128, 100)),
                                      (257, (248, 257)), (640, (500, 637)),
                                      (1024, None)])
def test_plain_matches_jax_every_row(n, valids, dh):
    q, k, v = _qkv(n + dh, 2, 2, n, dh)
    mask = _mask(n, valids)
    got, want = _plain(q, k, v, mask), _jax_flash(q, k, v, mask)
    assert got.shape == want.shape == (2, 2, n, dh)
    _assert_bounds(got, want, n)


def test_plain_matches_jax_without_qk_norm_scale():
    # qk_norm=False: scale dh^-0.5
    n, dh = 300, 16
    q, k, v = _qkv(5, 1, 2, n, dh)
    mask = _mask(n, (290,))
    _assert_bounds(_plain(q, k, v, mask, dh ** -0.5),
                   _jax_flash(q, k, v, mask, dh ** -0.5), n)


def test_masked_rows_attend_to_the_pad_segment():
    """Valid rows equal the dense key-masked softmax; masked rows do not:
    they attend to the masked keys and the n_pad - N pad keys (logit 0,
    value 0), which the dense path never forms."""
    n, valid, dh = 200, 150, 16
    q, k, v = (torch.from_numpy(t) for t in _qkv(9, 1, 2, n, dh))
    mask = torch.arange(n)[None, :] < valid
    got = ops.flash_attention_plain(q, k, v, mask, SCALE)
    sim = torch.matmul(q, k.transpose(-1, -2)) * SCALE
    dense = torch.matmul(sim.masked_fill(~mask[:, None, None, :],
                                         torch.finfo(sim.dtype).min)
                         .softmax(-1), v)
    torch.testing.assert_close(got[:, :, :valid], dense[:, :, :valid],
                               atol=1e-5, rtol=1e-5)
    assert (got[:, :, valid:] - dense[:, :, valid:]).abs().max() > 1e-2
    # by hand: segment-0 keys, then 56 pads that only add exp(0 - max)
    seg = ~mask[0]
    s = sim[:, :, valid:][..., seg]
    m = torch.clamp(s.amax(-1, keepdim=True), min=0.0)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True) + flash_pad(n) * torch.exp(-m)
    want = torch.matmul(p / den, v[:, :, seg])
    torch.testing.assert_close(got[:, :, valid:], want, atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_the_plain_version():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 1, 2, 130, 16))
    mask = torch.arange(130)[None, :] < 121
    torch.testing.assert_close(ops.flash_attention(q, k, v, mask, SCALE),
                               ops.flash_attention_plain(q, k, v, mask, SCALE),
                               rtol=0, atol=0)
    assert ops.flash_attention.launches == 0


# --- the modules around the kernel ------------------------------------------------

def _attention_params(rng, dim, heads, dh):
    inner = heads * dh
    return {"to_qkv": {"kernel": rng.standard_normal((dim, 3 * inner)).astype(
                np.float32) * dim ** -0.5},
            "q_norm": {"gamma": 1 + 0.1 * rng.standard_normal(
                (heads, 1, dh)).astype(np.float32)},
            "k_norm": {"gamma": 1 + 0.1 * rng.standard_normal(
                (heads, 1, dh)).astype(np.float32)},
            "to_out": {"kernel": rng.standard_normal((inner, dim)).astype(
                np.float32) * inner ** -0.5}}


@pytest.mark.parametrize("n,valids", [(256, None), (600, (600, 530))])
def test_attention_module_flash_matches_jax(n, valids):
    dim, heads, dh = 32, 2, 16
    rng = np.random.default_rng(n)
    prm = _attention_params(rng, dim, heads, dh)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    mask = _mask(n, valids)
    ja = JT.Attention(dim=dim, heads=heads, dim_head=dh, use_flash=True)
    with interpret():
        want = np.asarray(ja.apply(
            {"params": prm}, jnp.asarray(x), rotary=JT.rotary_freqs(n, dh),
            mask=None if mask is None else jnp.asarray(mask)))
    pa = Attention(dim, heads, dh, use_flash=True).eval()
    with torch.no_grad():
        pa.to_qkv.weight.copy_(torch.from_numpy(prm["to_qkv"]["kernel"].T))
        pa.to_out.weight.copy_(torch.from_numpy(prm["to_out"]["kernel"].T))
        pa.q_norm.gamma.copy_(torch.from_numpy(prm["q_norm"]["gamma"]))
        pa.k_norm.gamma.copy_(torch.from_numpy(prm["k_norm"]["gamma"]))
        got = pa(torch.from_numpy(x), rotary_freqs(n, dh),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


TINY = dict(dim_in=32, dim=64, depth=2, heads=2, dim_head=16)


@pytest.fixture(scope="module")
def flash_nets():
    cfg = JaxModelConfig(**TINY, attn_flash=True)
    jnet = JaxVectorFieldNet(cfg)
    x = jnp.zeros((1, 16, TINY["dim_in"]))
    params = jnet.init(jax.random.PRNGKey(0), x, times=jnp.zeros(()), cond=x)
    leaves, tree = jax.tree_util.tree_flatten(params)
    gen = np.random.default_rng(1)
    leaves = [np.asarray(leaf) + 0.05 * gen.standard_normal(leaf.shape).astype(
        np.float32) for leaf in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    pcfg = ModelConfig(**TINY, attn_flash=True)
    net = VectorFieldNet(pcfg).eval()
    net.load_state_dict(vector_field_state_from_jax(params, pcfg))
    return jnet, params, net


@pytest.mark.parametrize("t", [40, 600])
def test_vector_field_flash_matches_jax(flash_nets, t):
    """40 frames: one block, at tests/test_torch_vector_field.py's atol and
    rtol 1e-4. 600 frames: two 512 blocks; there the sharp qk-norm softmax
    (logits up to ~640) amplifies f32 rounding through two layers, and the
    dense path (port vs the JAX einsum) on the same inputs and weights
    differs by 3.0e-4 max, 3.8e-6 mean: the bound is max 5e-4, mean 1e-5."""
    jnet, params, net = flash_nets
    rng = np.random.default_rng(t)
    x, cond = (rng.standard_normal((2, t, TINY["dim_in"])).astype(np.float32)
               for _ in range(2))
    mask = np.ones((2, t), bool)
    mask[1, t - 13:] = False
    times = np.array([0.2, 0.7], np.float32)
    # one compiled program: the interpreter keeps global state per kernel,
    # and op-by-op dispatch of the two layers' kernels could hang under load
    with interpret():
        want = np.asarray(jax.jit(jnet.apply)(
            params, jnp.asarray(x), times=jnp.asarray(times),
            cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), times=torch.from_numpy(times),
                  cond=torch.from_numpy(cond),
                  mask=torch.from_numpy(mask)).numpy()
    d = np.abs(got - want)
    if t <= 512:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert d.max() <= 5e-4 and d.mean() <= 1e-5, (d.max(), d.mean())


def test_flash_model_takes_the_dense_state_dict(flash_nets):
    _, _, flash = flash_nets
    dense = VectorFieldNet(ModelConfig(**TINY)).eval()
    assert flash.state_dict().keys() == dense.state_dict().keys()
    dense.load_state_dict(flash.state_dict())
    # the seeded init (chip_smoke.py's weights) is the same for both
    a = seeded_init_(VectorFieldNet(ModelConfig(**TINY, attn_flash=True)), 3)
    b = seeded_init_(VectorFieldNet(ModelConfig(**TINY)), 3)
    for key, val in a.state_dict().items():
        torch.testing.assert_close(val, b.state_dict()[key], rtol=0, atol=0)
    # without masked frames the two attention paths differ by rounding only
    rng = np.random.default_rng(4)
    x, cond = (torch.from_numpy(rng.standard_normal((1, 50, TINY["dim_in"]))
                                .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        torch.testing.assert_close(flash(x, times=torch.tensor(0.3), cond=cond),
                                   dense(x, times=torch.tensor(0.3), cond=cond),
                                   atol=1e-5, rtol=1e-5)
