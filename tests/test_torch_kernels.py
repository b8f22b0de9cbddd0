"""flowhigh_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and nvcc (the kernels have
no CPU mode) and skips without one. This file imports no JAX, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat import seeded_init_
from flowhigh_tpu_torch.config import VocoderConfig
from flowhigh_tpu_torch.models import BigVGAN

pytestmark = pytest.mark.cuda

UPSAMPLERS = [(5, 11), (4, 8), (3, 7), (2, 4)]  # BigVGAN's (u, K) pairs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _randn(gen, device, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale)).to(device)


def _close(got, want):
    # the kernels sum in f32 in another order than cuDNN / the plain chain
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,c,t,with_beta", [(2, 48, 3000, True),
                                             (1, 16, 1025, False),
                                             (1, 4, 5, True)])
def test_snake_kernel_matches_plain(cuda, gen, b, c, t, with_beta):
    x = _randn(gen, cuda, b, c, t)
    a = _randn(gen, cuda, c, scale=0.3)
    beta = _randn(gen, cuda, c, scale=0.3) if with_beta else None
    n0 = ops.snake_activation1d.launches
    _close(ops.snake_activation1d(x, a, beta),
           ops.snake_activation1d_plain(x, a, beta))
    assert ops.snake_activation1d.launches == n0 + 1


@pytest.mark.parametrize("cin,cout,k,d,n_res", [(48, 48, 11, 5, 3),
                                                (96, 96, 3, 1, 1),
                                                (40, 70, 7, 3, 2),
                                                (45, 96, 3, 3, 1),
                                                (13, 64, 11, 1, 0),
                                                (48, 1, 7, 1, 0),
                                                (20, 3, 5, 2, 1)])
def test_conv1d_kernel_matches_plain(cuda, gen, cin, cout, k, d, n_res):
    t = 777
    x = _randn(gen, cuda, 2, cin, t)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = tuple(_randn(gen, cuda, 2, cout, t) for _ in range(n_res))
    n0 = ops.conv1d.launches
    _close(ops.conv1d(x, w, bias, dilation=d, residuals=res, out_scale=0.5),
           ops.conv1d_plain(x, w, bias, dilation=d, residuals=res,
                            out_scale=0.5))
    assert ops.conv1d.launches == n0 + 1


@pytest.mark.parametrize("u,k", UPSAMPLERS)
def test_conv_transpose1d_kernel_matches_plain(cuda, gen, u, k):
    x = _randn(gen, cuda, 2, 40, 101)
    w = _randn(gen, cuda, 40, 24, k, scale=(24 * k) ** -0.5)
    bias = _randn(gen, cuda, 24)
    n0 = ops.conv_transpose1d.launches
    _close(ops.conv_transpose1d(x, w, bias, stride=u),
           ops.conv_transpose1d_plain(x, w, bias, stride=u))
    assert ops.conv_transpose1d.launches == n0 + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, gen):
    x = _randn(gen, cuda, 1, 8, 64)
    w = _randn(gen, cuda, 8, 8, 3)
    with pytest.raises(ValueError):  # not contiguous
        ops.conv1d(x.transpose(1, 2).contiguous().transpose(1, 2), w, None)
    with pytest.raises(ValueError):  # even kernel
        ops.conv1d(x, _randn(gen, cuda, 8, 8, 4), None)
    with pytest.raises(ValueError):  # no instance for K = 5 at Cout >= 16
        ops.conv1d(_randn(gen, cuda, 1, 16, 64), _randn(gen, cuda, 16, 16, 5),
                   None)
    with pytest.raises(ValueError):  # no instance for this (stride, K)
        ops.conv_transpose1d(x, _randn(gen, cuda, 8, 4, 10), None, stride=5)
    with pytest.raises(ValueError):  # float64
        ops.snake_activation1d(x.double(), torch.zeros(8, device=cuda), None)


def test_vocoder_on_card_matches_cpu(cuda, gen):
    cfg = VocoderConfig(upsample_initial_channel=64)
    voc = seeded_init_(BigVGAN(cfg).eval(), 0)
    mel = _randn(gen, "cpu", 1, 20, cfg.num_mels)
    with torch.inference_mode():
        want = voc(mel)
        ops.reset_launch_counts()
        got = voc.to(cuda)(mel.to(cuda)).cpu()
    assert [fn.launches for fn in ops.KERNELS] == [91, 91, 5]
    # 91 + 91 + 5 kernels in place of cuDNN / the plain chain, through a
    # random-weight generator
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
