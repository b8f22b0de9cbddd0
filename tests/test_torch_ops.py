"""The port's kernel modules against the JAX package's Pallas kernels (run in
interpret mode on the CPU): each plain PyTorch version computes what its
Pallas counterpart computes. On a CPU tensor every wrapper takes the plain
version and leaves its launch count at 0. The kernels themselves need the
card: tests/test_torch_kernels.py holds them against the plain versions.

Layouts: the JAX kernels take [B, T, C] and HIO / [K, Cout, Cin] weights;
the port takes [B, C, T] and PyTorch's weight layouts. Tests transpose at
the comparison, never inside the code under test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowhigh_tpu.ops.fused_act import fused_snake_activation1d
from flowhigh_tpu.ops.packed import (pack_time, packed_snake_activation1d,
                                     pallas_packed_conv1d,
                                     pallas_packed_conv_transpose1d,
                                     unpack_time)
from flowhigh_tpu_torch import ops

UPSAMPLERS = [(5, 11), (4, 8), (3, 7), (2, 4)]  # BigVGAN's (u, K) pairs


def _btc(x):  # port [B, C, T] -> JAX [B, T, C]
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


def _snake_inputs(rng, t, c, with_beta):
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    a = (rng.standard_normal(c) * 0.3).astype(np.float32)
    b = (rng.standard_normal(c) * 0.3).astype(np.float32) if with_beta else None
    return x, a, b


@pytest.mark.parametrize("with_beta,logscale", [(True, True), (False, False)])
def test_snake_plain_matches_fused_pallas(rng, with_beta, logscale):
    x, a, b = _snake_inputs(rng, 96, 32, with_beta)
    if not logscale:
        a = np.abs(a) + 0.5
    want = np.asarray(fused_snake_activation1d(
        jnp.asarray(_btc(x)), jnp.asarray(a),
        None if b is None else jnp.asarray(b), logscale, True))
    got = ops.snake_activation1d_plain(
        torch.from_numpy(x), torch.from_numpy(a),
        None if b is None else torch.from_numpy(b), logscale).numpy()
    got = _btc(got)
    # as tests/test_fused_act.py: f32 reassociation + the kernel's
    # polynomial cos
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # the replicate-padded edges (the JAX kernel's _patch_edges) too
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[:, -3:], want[:, -3:], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("with_beta", [True, False])
def test_snake_plain_matches_packed_pallas(rng, with_beta):
    x, a, b = _snake_inputs(rng, 128, 24, with_beta)
    xp = pack_time(jnp.asarray(_btc(x)), 2)
    want = np.asarray(unpack_time(packed_snake_activation1d(
        xp, jnp.asarray(a), None if b is None else jnp.asarray(b), True, 2,
        interpret=True), 2))
    got = _btc(ops.snake_activation1d_plain(
        torch.from_numpy(x), torch.from_numpy(a),
        None if b is None else torch.from_numpy(b), True).numpy())
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[:, -3:], want[:, -3:], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("k,d,n_res,scale", [(3, 1, 0, 1.0), (7, 3, 1, 1.0),
                                             (11, 5, 3, 1.0 / 3)])
def test_conv1d_plain_matches_pallas(rng, k, d, n_res, scale):
    c, t = 16, 160
    x = rng.standard_normal((1, c, t)).astype(np.float32)
    w = (rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    res = [rng.standard_normal((1, c, t)).astype(np.float32)
           for _ in range(n_res)]
    want = np.asarray(pallas_packed_conv1d(
        jnp.asarray(_btc(x)), jnp.asarray(w.transpose(2, 1, 0)),
        jnp.asarray(b), pad=d * (k - 1) // 2, dilation=d, p=1,
        residual=[jnp.asarray(_btc(r)) for r in res] or None, out_scale=scale,
        dot_dtype=jnp.float32, interpret=True))
    got = ops.conv1d_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), dilation=d,
                           residuals=[torch.from_numpy(r) for r in res],
                           out_scale=scale).numpy()
    # exact f32 dots on both sides; only the summation order differs
    np.testing.assert_allclose(_btc(got), want, atol=1e-4, rtol=1e-4)


def test_conv1d_plain_single_output_channel(rng):
    # conv_post: 48 -> 1, k7
    x = rng.standard_normal((1, 48, 200)).astype(np.float32)
    w = (rng.standard_normal((1, 48, 7)) / np.sqrt(48 * 7)).astype(np.float32)
    b = np.array([0.05], np.float32)
    want = np.asarray(pallas_packed_conv1d(
        jnp.asarray(_btc(x)), jnp.asarray(w.transpose(2, 1, 0)),
        jnp.asarray(b), pad=3, dilation=1, p=1, dot_dtype=jnp.float32,
        interpret=True))
    got = ops.conv1d_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("u,k", UPSAMPLERS)
def test_conv_transpose1d_plain_matches_pallas(rng, u, k):
    cin, cout, t = 16, 8, 40
    x = rng.standard_normal((1, cin, t)).astype(np.float32)
    w = (rng.standard_normal((cin, cout, k)) / np.sqrt(cout * k)).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.asarray(pallas_packed_conv_transpose1d(
        jnp.asarray(_btc(x)), jnp.asarray(w.transpose(2, 1, 0)),
        jnp.asarray(b), stride=u, padding=(k - u) // 2, p_in=1, p_out=1,
        interpret=True))
    got = ops.conv_transpose1d_plain(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), stride=u).numpy()
    assert got.shape == (1, cout, u * t)
    np.testing.assert_allclose(_btc(got), want, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_versions(rng):
    ops.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32))
    a = torch.zeros(8)
    w = torch.from_numpy(rng.standard_normal((8, 8, 3)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((8, 4, 8)).astype(np.float32))
    torch.testing.assert_close(ops.snake_activation1d(x, a, a),
                               ops.snake_activation1d_plain(x, a, a),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.conv1d(x, w, None, residuals=(x,)),
                               ops.conv1d_plain(x, w, None, residuals=(x,)),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.conv_transpose1d(x, wt, None, stride=4),
                               ops.conv_transpose1d_plain(x, wt, None, stride=4),
                               rtol=0, atol=0)
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)
