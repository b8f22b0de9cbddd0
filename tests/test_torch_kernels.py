"""flowhigh_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and nvcc (the kernels have
no CPU mode) and skips without one. This file imports no JAX, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat import seeded_init_
from flowhigh_tpu_torch.config import VocoderConfig
from flowhigh_tpu_torch.models import BigVGAN
from flowhigh_tpu_torch.ops import _build, fused_conv, probes

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]

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


# kernel A (csrc/snake_aa.cu): strips of 8 outputs a thread, tiles of 1,024
# a block; interior tiles need T % 4 == 0 and 8 samples beyond the tile
A_STRIP, A_TILE = 8, 1024
SNAKE_CASES = [
    (2, 48, 3000, True, True), (1, 16, 1025, False, True),
    (1, 4, 5, True, True),
    # each stage's C at a cut T (interior tiles at 4,100 and 2,056)
    (1, 768, 5000, True, True), (1, 384, 4100, True, True),
    (1, 192, 3000, True, True), (1, 96, 2056, True, True),
    (1, 48, 4096, True, True),
    # rows shorter than the down FIR, a strip, a tile
    (1, 4, 1, True, True), (1, 4, 2, True, True), (1, 4, 12, True, True),
    (1, 4, 13, True, True),
    # one more than a whole number of strips and of tiles, with T % 4 == 0
    # beside (interior tiles) and not (the clamped path throughout)
    (1, 8, A_STRIP + 1, True, True), (1, 8, 32 * A_STRIP + 1, True, True),
    (1, 8, A_TILE + 1, True, True), (1, 8, 2 * A_TILE + 1, True, True),
    (1, 8, 3 * A_TILE + 8, True, True), (1, 8, 3 * A_TILE + 9, True, True),
    (1, 8, 3 * A_TILE + 12, True, True),
    (1, 8, 2 * A_TILE + A_STRIP + 1, True, True),
    # plain snake (beta = None) and linear-scale parameters
    (1, 96, 4100, False, True), (1, 96, 4100, True, False),
    (1, 96, 4100, False, False),
    # B * C above 65,535 (the grid is one-dimensional over rows and tiles)
    (86, 768, 13, True, True), (2, 33000, 2056, True, True)]


@pytest.mark.parametrize("b,c,t,with_beta,logscale", SNAKE_CASES)
def test_snake_kernel_matches_plain(cuda, gen, b, c, t, with_beta, logscale):
    x = _randn(gen, cuda, b, c, t)
    a = _randn(gen, cuda, c, scale=0.3)
    beta = _randn(gen, cuda, c, scale=0.3) if with_beta else None
    if not logscale:  # positive alpha, beta as the linear parameters are
        a = a.abs() + 0.5
        beta = None if beta is None else beta.abs() + 0.5
    n0 = ops.snake_activation1d.launches
    _close(ops.snake_activation1d(x, a, beta, logscale),
           ops.snake_activation1d_plain(x, a, beta, logscale))
    assert ops.snake_activation1d.launches == n0 + 1


def test_snake_kernel_takes_any_alignment(cuda, gen):
    # a row view one float in: the pointers rule out 16-byte access, so
    # every tile takes the clamped path
    base = _randn(gen, cuda, 1 + 8 * 4100)
    x = base[1:].view(1, 8, 4100)
    a, beta = _randn(gen, cuda, 8, scale=0.3), _randn(gen, cuda, 8, scale=0.3)
    _close(ops.snake_activation1d(x, a, beta),
           ops.snake_activation1d_plain(x, a, beta))


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


# AMPBlock2's convs (models/bigvgan.py): every stage's width, K 3 / 7 / 11
# at d 1 / 3 / 5, with x itself as the residual; T cut to 2,000 frames
@pytest.mark.parametrize("c", [768, 384, 192, 96, 48])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_conv1d_ampblock2_shapes_match_plain(cuda, gen, c, k, d):
    x = _randn(gen, cuda, 1, c, 2000)
    w = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    bias = _randn(gen, cuda, c, scale=0.1)
    kw = dict(dilation=d, residuals=(x,))
    _close(ops.conv1d(x, w, bias, **kw), ops.conv1d_plain(x, w, bias, **kw))


# kernel B's GEMM route at its edges: (B, Cin, Cout, T, K, d, residuals):
# Cout 48 and 96 (48-channel tiles), 64, 128 and 70 (a ragged 64-channel
# tile), Cin off the 8 / 16-channel chunk, T off the 256-frame tile, T a
# multiple of 4 (16-byte epilogue) and not, T below the taps' reach,
# batch up to 4
CONV_GEMM_SHAPES = [(1, 48, 48, 1000, 11, 5, 3), (2, 96, 96, 777, 3, 3, 1),
                    (4, 64, 64, 260, 7, 1, 0), (1, 40, 70, 3, 11, 3, 2),
                    (2, 20, 128, 513, 7, 5, 1), (1, 192, 96, 2048, 3, 1, 0)]


@pytest.mark.parametrize("b,cin,cout,t,k,d,n_res", CONV_GEMM_SHAPES)
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_conv1d_gemm_route_matches_plain(cuda, gen, dot_dtype, b, cin, cout,
                                         t, k, d, n_res):
    x = _randn(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = tuple(_randn(gen, cuda, b, cout, t) for _ in range(n_res))
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    _close(ops.conv1d(x, w, bias, **kw), ops.conv1d_plain(x, w, bias, **kw))


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_conv1d_stage1_full_width(cuda, gen, dot_dtype):
    # the 10 s clip's first resblock stage: 768 channels, T = 5,000, the
    # deepest sums (Cin K = 8,448) and the widest reach (K 11, d 5), and the
    # last unit's conv2 with its three residuals and the 1/3 average
    x = _randn(gen, cuda, 1, 768, 5000)
    w = _randn(gen, cuda, 768, 768, 11, scale=(768 * 11) ** -0.5)
    bias = _randn(gen, cuda, 768, scale=0.1)
    res = tuple(_randn(gen, cuda, 1, 768, 5000) for _ in range(3))
    for kw in (dict(dilation=5), dict(dilation=1, residuals=res,
                                      out_scale=1.0 / 3)):
        _close(ops.conv1d(x, w, bias, dot_dtype=dot_dtype, **kw),
               ops.conv1d_plain(x, w, bias, dot_dtype=dot_dtype, **kw))


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_conv1d_narrow_route_matches_plain(cuda, gen, dot_dtype):
    # conv_post at a 10 s clip's width (16-byte staging), then x with rows
    # off 16-byte alignment (4-byte staging) and a wide reach
    x = _randn(gen, cuda, 1, 48, 480000)
    w = _randn(gen, cuda, 1, 48, 7, scale=(48 * 7) ** -0.5)
    bias = _randn(gen, cuda, 1, scale=0.1)
    kw = dict(dot_dtype=dot_dtype)
    _close(ops.conv1d(x, w, bias, **kw), ops.conv1d_plain(x, w, bias, **kw))
    xs = _randn(gen, cuda, 2, 21, 1001)[1:]  # a contiguous view, offset
    w = _randn(gen, cuda, 2, 21, 9, scale=(21 * 9) ** -0.5)
    kw = dict(dilation=7, residuals=(_randn(gen, cuda, 1, 2, 1001),),
              dot_dtype=dot_dtype)
    _close(ops.conv1d(xs, w, None, **kw), ops.conv1d_plain(xs, w, None, **kw))


# kernel C's edges, at every (u, K) instance: (B, Cin, Cout, T) with a
# ragged Cin chunk (40, 17), Cout 24, 48 and 70 (a ragged 64-channel tile),
# T off every time tile, T below the tap halo, and u*T both a multiple of 4
# (16-byte stores) and not
CONVT_INSTANCES = UPSAMPLERS + [(8, 16)]
CONVT_SHAPES = [(2, 40, 24, 101), (1, 96, 48, 133), (2, 17, 70, 257),
                (1, 40, 48, 3)]


@pytest.mark.parametrize("b,cin,cout,t", CONVT_SHAPES)
@pytest.mark.parametrize("u,k", CONVT_INSTANCES)
def test_conv_transpose1d_kernel_matches_plain(cuda, gen, u, k, b, cin, cout,
                                               t):
    x = _randn(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cin, cout, k, scale=(cout * k) ** -0.5)
    bias = _randn(gen, cuda, cout)
    n0 = ops.conv_transpose1d.launches
    _close(ops.conv_transpose1d(x, w, bias, stride=u),
           ops.conv_transpose1d_plain(x, w, bias, stride=u))
    assert ops.conv_transpose1d.launches == n0 + 1


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_conv_transpose1d_stage1_full_width(cuda, gen, dot_dtype):
    # BigVGAN's first upsampler on a 10 s clip: 1536 -> 768, T = 1,000,
    # (5, 11); without bias, as kernel C also runs
    x = _randn(gen, cuda, 1, 1536, 1000)
    w = _randn(gen, cuda, 1536, 768, 11, scale=(768 * 11) ** -0.5)
    for bias in (_randn(gen, cuda, 768, scale=0.1), None):
        _close(ops.conv_transpose1d(x, w, bias, stride=5, dot_dtype=dot_dtype),
               ops.conv_transpose1d_plain(x, w, bias, stride=5,
                                          dot_dtype=dot_dtype))


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


# kernels D and E at every (K, d) instance, with T not a multiple of the
# tile, T shorter than the halo, B = 2 and 0-3 residuals (0-2 extras)
FUSED = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.parametrize("k,d", FUSED)
def test_act_conv1d_kernel_matches_plain(cuda, gen, k, d):
    i = FUSED.index((k, d))
    b, c, t = 1 + i % 2, (48, 64, 96, 40)[i % 4], (777, 5, 300)[i % 3]
    n_res = i % 4
    x = _randn(gen, cuda, b, c, t)
    a, be = _randn(gen, cuda, c, scale=0.3), _randn(gen, cuda, c, scale=0.3)
    w = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    bias = _randn(gen, cuda, c, scale=0.1)
    res = tuple(_randn(gen, cuda, b, c, t) for _ in range(n_res))
    args = (x, a, be if i % 3 else None, True, w, bias if i % 2 else None)
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3)
    n0 = ops.act_conv1d.launches
    got = ops.act_conv1d(*args, **kw)
    _close(got, ops.act_conv1d_plain(*args, **kw))
    assert ops.act_conv1d.launches == n0 + 1
    # kernel D's activation is kernel A's: D with an identity conv (channel
    # co's centre tap on channel co) returns A's output. Kernel B sums on the
    # tensor cores, in another order than D's FMA loop, so the A + B chain
    # is held to D at the kernels' tolerance
    eye = torch.zeros_like(w)
    eye[torch.arange(c), torch.arange(c), (k - 1) // 2] = 1.0
    torch.testing.assert_close(
        ops.act_conv1d(*args[:4], eye, None, dilation=d),
        ops.snake_activation1d(*args[:4]), atol=1e-6, rtol=0)
    chain = ops.conv1d(ops.snake_activation1d(*args[:4]), w, args[5], **kw)
    _close(got, chain)


@pytest.mark.parametrize("k,d", FUSED)
def test_amp_unit_kernel_matches_plain(cuda, gen, k, d):
    i = FUSED.index((k, d))
    b, c = 1 + i % 2, (48, 96, 192, 160)[i % 4]
    t, n_extra = (777, 5, 37, 1000)[i % 4], i % 3
    x = _randn(gen, cuda, b, c, t, scale=0.5)
    acts = [_randn(gen, cuda, c, scale=0.3) for _ in range(4)]
    w1 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    w2 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    b1, b2 = _randn(gen, cuda, c, scale=0.1), _randn(gen, cuda, c, scale=0.1)
    ex = tuple(_randn(gen, cuda, b, c, t) for _ in range(n_extra))
    args = (x, acts[0], acts[1] if i % 2 else None, acts[2], acts[3], True,
            w1, b1, w2, b2 if i % 3 else None)
    kw = dict(dilation=d, extra_residuals=ex, out_scale=0.5)
    n0 = ops.amp_unit.launches
    _close(ops.amp_unit(*args, **kw), ops.amp_unit_plain(*args, **kw))
    assert ops.amp_unit.launches == n0 + 1


# the tensor-core route of D and E (act_conv_mma) at its tile boundaries:
# D's 128-sample tile and 128- or 64-channel blocks, E's passes (192 x 192
# at C = 192, 96 / 48 x 256, else 64 x 192); T off the tile and below one
# tile, Cin off the 8 / 16-channel chunk (D), every stage width
# (Cin, Cout, T, K, d) of kernel D
MMA_PAIRS = [(768, 768, 293, 11, 5), (384, 384, 100, 7, 3),
             (196, 192, 293, 3, 5), (100, 96, 129, 11, 1),
             (52, 48, 1, 3, 3), (40, 130, 257, 7, 1)]
# (C, T, K, d) of kernel E; C = 200 passes 64 x 192 with a partial block
MMA_UNITS = [(192, 293, 11, 5), (192, 100, 3, 1), (96, 500, 7, 3),
             (48, 1000, 11, 1), (160, 171, 3, 3), (48, 3, 7, 5),
             (200, 777, 7, 3)]


def _launches(fn, dot_dtype):
    return fn.launches if dot_dtype == torch.float32 \
        else fn.variant_launches[dot_dtype]


def _close_dtype(name, key, got, want, dot_dtype):
    if dot_dtype == torch.float32:
        _close(got, want)
    else:  # chip_smoke.py's tolerance of the variants
        cs = _chip_smoke()
        cs._compare(name + cs.suffix(dot_dtype), key, got, want)


@pytest.mark.parametrize("cin,cout,t,k,d", MMA_PAIRS)
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_act_conv1d_tensor_core_tiles(cuda, gen, dot_dtype, cin, cout, t, k,
                                      d):
    x = _randn(gen, cuda, 1, cin, t)
    a, be = _randn(gen, cuda, cin, scale=0.3), _randn(gen, cuda, cin, scale=0.3)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = (_randn(gen, cuda, 1, cout, t),)
    args = (x, a, be, True, w, bias)
    kw = dict(dilation=d, residuals=res, out_scale=0.5, dot_dtype=dot_dtype)
    n0 = _launches(ops.act_conv1d, dot_dtype)
    got = ops.act_conv1d(*args, **kw)
    assert _launches(ops.act_conv1d, dot_dtype) == n0 + 1
    _close_dtype("act_conv1d", (cin, cout, t), got,
                 ops.act_conv1d_plain(*args, **kw), dot_dtype)


@pytest.mark.parametrize("c,t,k,d", MMA_UNITS)
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_amp_unit_tensor_core_tiles(cuda, gen, dot_dtype, c, t, k, d):
    x = _randn(gen, cuda, 1, c, t, scale=0.5)
    acts = [_randn(gen, cuda, c, scale=0.3) for _ in range(4)]
    w1 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    w2 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    b1, b2 = _randn(gen, cuda, c, scale=0.1), _randn(gen, cuda, c, scale=0.1)
    ex = (_randn(gen, cuda, 1, c, t),)
    args = (x, *acts[:4], True, w1, b1, w2, b2)
    kw = dict(dilation=d, extra_residuals=ex, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    n0 = _launches(ops.amp_unit, dot_dtype)
    got = ops.amp_unit(*args, **kw)
    assert _launches(ops.amp_unit, dot_dtype) == n0 + 1
    _close_dtype("amp_unit", (c, t), got, ops.amp_unit_plain(*args, **kw),
                 dot_dtype)


def test_fused_smem_arithmetic_matches_the_kernels(cuda):
    lib_d, lib_e = _build.library("act_conv1d"), _build.library("amp_unit")
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1), (torch.int8, 2)):
        for c in (768, 384, 200, 192, 160, 96, 64, 48):
            for k in (3, 7, 11):
                for d in (1, 3, 5):
                    assert lib_d.act_conv1d_smem_bytes(k, d, c, code) == \
                        fused_conv.act_conv_smem_bytes(k, d, c, dt)
                    assert lib_e.amp_unit_smem_bytes(k, d, c, code) == \
                        fused_conv.amp_unit_smem_bytes(k, d, c, dt)


def test_fused_wrappers_raise_without_an_instance(cuda, gen):
    x = _randn(gen, cuda, 1, 16, 64)
    a = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError):  # no K = 5 instance
        ops.act_conv1d(x, a, None, True, _randn(gen, cuda, 16, 16, 5), None,
                       dilation=1)
    wide = _randn(gen, cuda, 1, 384, 64)
    w = _randn(gen, cuda, 384, 384, 3)
    aw = torch.zeros(384, device=cuda)
    with pytest.raises(ValueError, match="amp_unit_plan"):  # does not fit
        ops.amp_unit(wide, aw, None, aw, None, True, w, None, w, None,
                     dilation=1)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _main_path_calls(cfg, frames, fuse):
    chip_smoke = _chip_smoke()
    calls = chip_smoke.main_path_calls(cfg, frames, fuse)
    return [sum(calls[k].values()) for k in chip_smoke.KERNEL_NAMES]


def _vocoder_on_card_vs_cpu(cuda, gen, cfg, fuse):
    voc = seeded_init_(BigVGAN(cfg, fuse_act_conv=fuse).eval(), 0)
    mel = _randn(gen, "cpu", 1, 8, cfg.num_mels)
    with torch.inference_mode():
        want = voc(mel)
        ops.reset_launch_counts()
        got = voc.to(cuda)(mel.to(cuda)).cpu()
    counts = [fn.launches for fn in ops.KERNELS]
    # the kernels in place of cuDNN / the plain chain, through a
    # random-weight generator
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    return counts


def test_vocoder_on_card_matches_cpu(cuda, gen):
    # the default path: at C = 512 and 256 no unit fits, so their pairs take
    # kernel D; the narrower stages take kernel E; all five vocoder kernels
    # launch, and the attention kernel F does not
    cfg = VocoderConfig(upsample_initial_channel=1024)
    counts = _vocoder_on_card_vs_cpu(cuda, gen, cfg, True)
    assert counts[:5] == _main_path_calls(cfg, 8, True) == [1, 1, 5, 36, 27]
    assert counts[5:] == [0]


def test_unfused_vocoder_on_card_matches_cpu(cuda, gen):
    cfg = VocoderConfig(upsample_initial_channel=64)
    counts = _vocoder_on_card_vs_cpu(cuda, gen, cfg, False)
    assert counts == [91, 91, 5, 0, 0, 0]


@pytest.mark.parametrize("fuse", [True, False])
def test_resblock2_vocoder_on_card_matches_cpu(cuda, gen, fuse):
    # AMPBlock2: per stage 3 resblocks x 3 dilations of kernel A then
    # kernel B with x as its residual, whatever fuse_act_conv says
    cfg = VocoderConfig(upsample_initial_channel=64, resblock="2")
    counts = _vocoder_on_card_vs_cpu(cuda, gen, cfg, fuse)
    assert counts[:5] == _main_path_calls(cfg, 8, fuse) == [46, 46, 5, 0, 0]
    assert counts[5:] == [0]


# kernel F (flash attention) with masks, N not a multiple of the tile or the
# block, B = 2 and every D instance; all rows, masked ones included
FLASH = [(1, 2, 128, (128,), 16), (2, 2, 257, (248, 257), 16),
         (2, 3, 640, (500, 631), 32), (1, 16, 1000, (950,), 64),
         (2, 16, 1030, (1030, 900), 64), (1, 1, 5, (3,), 32)]


@pytest.mark.parametrize("b,h,n,valids,dh", FLASH)
def test_flash_attention_kernel_matches_plain(cuda, gen, b, h, n, valids, dh):
    q, k, v = (_randn(gen, cuda, b, h, n, dh) for _ in range(3))
    mask = (torch.arange(n, device=cuda)[None, :]
            < torch.tensor(valids, device=cuda)[:, None])
    n0 = ops.flash_attention.launches
    for m in (mask, None):
        got = ops.flash_attention(q, k, v, m, 10.0)
        torch.cuda.synchronize()
        # the kernel's running softmax (3xTF32 products) against the plain
        # version's dense one, evaluated in float64: in float32 the plain
        # version's own rounding of the sharp scores reaches this tolerance
        # at D = 64 (tests/test_torch_flash_plan.py), which the direct-FMA
        # kernel F before the tensor cores met only by sharing it
        torch.testing.assert_close(
            got.double(), ops.flash_attention_plain(
                q.double(), k.double(), v.double(), m, 10.0),
            atol=1e-4, rtol=1e-4)
    assert ops.flash_attention.launches == n0 + 2


# kernel F on register-padded inputs (ModelConfig.num_register_tokens): r
# leading key columns valid in every item, then each item's frames
FLASH_REGISTERS = [(2, 16, 1000, (1000, 900), 64, 16),
                   (2, 2, 130, (130, 77), 16, 3)]


@pytest.mark.parametrize("b,h,n,valids,dh,r", FLASH_REGISTERS)
def test_flash_attention_with_register_columns_matches_plain(
        cuda, gen, b, h, n, valids, dh, r):
    q, k, v = (_randn(gen, cuda, b, h, r + n, dh) for _ in range(3))
    frames = (torch.arange(n, device=cuda)[None, :]
              < torch.tensor(valids, device=cuda)[:, None])
    mask = torch.cat([torch.ones(b, r, dtype=torch.bool, device=cuda),
                      frames], dim=1)
    got = ops.flash_attention(q, k, v, mask, 10.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.double(), ops.flash_attention_plain(
            q.double(), k.double(), v.double(), mask, 10.0),
        atol=1e-4, rtol=1e-4)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(
        cuda, gen):
    q = _randn(gen, cuda, 1, 2, 64, 48)
    with pytest.raises(ValueError, match="D=48"):  # no instance for D = 48
        ops.flash_attention(q, q, q, None, 1.0)
    q = _randn(gen, cuda, 1, 2, 64, 16)
    with pytest.raises(ValueError):  # not contiguous
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            q, q, None, 1.0)
    with pytest.raises(ValueError):  # mask of another shape
        ops.flash_attention(q, q, q, torch.ones(1, 63, dtype=torch.bool,
                                                device=cuda), 1.0)


def test_flash_attention_refuses_autograd_as_the_jax_package(cuda, gen):
    """Kernel F is forward only, as the JAX function is (its library kernel
    gets no backward block sizes, so differentiating it raises): under
    autograd the wrapper raises the same ValueError instead of returning an
    output that no gradient flows through. Without a gradient it runs."""
    from flowhigh_tpu_torch.config import ModelConfig
    from flowhigh_tpu_torch.models import VectorFieldNet
    q, k, v = (_randn(gen, cuda, 1, 2, 64, 16) for _ in range(3))
    with pytest.raises(ValueError, match="backward blocks"):
        ops.flash_attention(q.requires_grad_(), k, v, None, 10.0)
    with torch.no_grad():
        assert torch.isfinite(ops.flash_attention(q, k, v, None, 10.0)).all()
    net = seeded_init_(VectorFieldNet(ModelConfig(
        dim_in=32, dim=64, depth=2, heads=2, dim_head=16, attn_flash=True)),
        0).to(cuda).train()
    x = _randn(gen, cuda, 2, 40, 32)
    with pytest.raises(ValueError, match="backward blocks"):
        net(x, times=torch.full((2,), 0.3, device=cuda), cond=x).sum()


def test_flash_vector_field_on_card_matches_cpu(cuda, gen):
    from flowhigh_tpu_torch.config import ModelConfig
    from flowhigh_tpu_torch.models import VectorFieldNet
    cfg = ModelConfig(dim_in=32, dim=64, depth=2, heads=2, dim_head=16,
                      attn_flash=True)
    net = seeded_init_(VectorFieldNet(cfg).eval(), 0)
    x, cond = (_randn(gen, "cpu", 2, 600, 32) for _ in range(2))
    mask = torch.ones(2, 600, dtype=torch.bool)
    mask[1, 550:] = False
    with torch.inference_mode():
        want = net(x, times=torch.tensor(0.3), cond=cond, mask=mask)
        ops.reset_launch_counts()
        got = net.to(cuda)(x.to(cuda), times=torch.tensor(0.3, device=cuda),
                           cond=cond.to(cuda), mask=mask.to(cuda)).cpu()
    assert ops.flash_attention.launches == 2  # one per layer
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


# the vector field's options (register tokens with kernel F, U-Net skips,
# GateLoop; the ConvNeXt backbone) on the card against the CPU
FIELD_OPTIONS = {
    "all_flash": dict(num_register_tokens=16, use_unet_skip_connection=True,
                      use_gateloop_layers=True, attn_flash=True),
    "convnext": dict(architecture="convnext")}


@pytest.mark.parametrize("name", FIELD_OPTIONS)
def test_vector_field_options_on_card_match_cpu(cuda, gen, name):
    from flowhigh_tpu_torch.config import ModelConfig
    from flowhigh_tpu_torch.models import VectorFieldNet
    cfg = ModelConfig(dim_in=32, dim=64, depth=2, heads=2, dim_head=16,
                      **FIELD_OPTIONS[name])
    net = seeded_init_(VectorFieldNet(cfg).eval(), 0)
    x, cond = (_randn(gen, "cpu", 2, 600, 32) for _ in range(2))
    mask = torch.ones(2, 600, dtype=torch.bool)
    mask[1, 550:] = False
    with torch.inference_mode():
        want = net(x, times=torch.tensor(0.3), cond=cond, mask=mask)
        ops.reset_launch_counts()
        got = net.to(cuda)(x.to(cuda), times=torch.tensor(0.3, device=cuda),
                           cond=cond.to(cuda), mask=mask.to(cuda)).cpu()
    assert ops.flash_attention.launches == (2 if cfg.attn_flash else 0)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


# --- the reduced-precision instances (dot_dtype bfloat16 and int8) -----------

VARIANT_CONVS = [(torch.bfloat16, 48, 48, 11, 5, 3), (torch.bfloat16, 40, 70, 7, 3, 1),
                 (torch.bfloat16, 48, 1, 7, 1, 0), (torch.int8, 48, 48, 11, 5, 2),
                 (torch.int8, 96, 96, 3, 1, 1), (torch.int8, 45, 64, 7, 3, 0)]


@pytest.mark.parametrize("dot_dtype,cin,cout,k,d,n_res", VARIANT_CONVS)
def test_conv1d_variant_matches_plain(cuda, gen, dot_dtype, cin, cout, k, d,
                                      n_res):
    # the same input tensor on both sides: the same bf16 roundings, the same
    # int8 windows and integer sums; only the f32 epilogue's order differs
    t = 777
    x = _randn(gen, cuda, 2, cin, t)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = tuple(_randn(gen, cuda, 2, cout, t) for _ in range(n_res))
    kw = dict(dilation=d, residuals=res, out_scale=0.5, dot_dtype=dot_dtype)
    n0, v0 = ops.conv1d.launches, ops.conv1d.variant_launches[dot_dtype]
    _close(ops.conv1d(x, w, bias, **kw), ops.conv1d_plain(x, w, bias, **kw))
    assert ops.conv1d.variant_launches[dot_dtype] == v0 + 1
    assert ops.conv1d.launches == n0


@pytest.mark.parametrize("b,cin,cout,t", CONVT_SHAPES)
@pytest.mark.parametrize("u,k", CONVT_INSTANCES)
def test_conv_transpose1d_bf16_matches_plain(cuda, gen, u, k, b, cin, cout, t):
    x = _randn(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cin, cout, k, scale=(cout * k) ** -0.5)
    bias = _randn(gen, cuda, cout)
    v0 = ops.conv_transpose1d.variant_launches[torch.bfloat16]
    _close(ops.conv_transpose1d(x, w, bias, stride=u, dot_dtype=torch.bfloat16),
           ops.conv_transpose1d_plain(x, w, bias, stride=u,
                                      dot_dtype=torch.bfloat16))
    assert ops.conv_transpose1d.variant_launches[torch.bfloat16] == v0 + 1


# (dot_dtype, K, d, B, C, T): T over several tiles, T below one tile, every K
VARIANT_FUSED = [(torch.bfloat16, 3, 5, 2, 48, 777), (torch.bfloat16, 7, 3, 1, 96, 300),
                 (torch.bfloat16, 11, 1, 1, 64, 5), (torch.int8, 3, 1, 1, 96, 777),
                 (torch.int8, 7, 5, 2, 48, 300), (torch.int8, 11, 3, 1, 64, 37)]


@pytest.mark.parametrize("dot_dtype,k,d,b,c,t", VARIANT_FUSED)
def test_act_conv1d_variant_matches_plain(cuda, gen, dot_dtype, k, d, b, c, t):
    x = _randn(gen, cuda, b, c, t)
    a, be = _randn(gen, cuda, c, scale=0.3), _randn(gen, cuda, c, scale=0.3)
    w = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    bias = _randn(gen, cuda, c, scale=0.1)
    res = (_randn(gen, cuda, b, c, t),)
    args = (x, a, be, True, w, bias)
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    v0 = ops.act_conv1d.variant_launches[dot_dtype]
    cs = _chip_smoke()  # chip_smoke.py's tolerance of the variants
    cs._compare("act_conv1d" + cs.suffix(dot_dtype), (b, c, t),
                ops.act_conv1d(*args, **kw), ops.act_conv1d_plain(*args, **kw))
    assert ops.act_conv1d.variant_launches[dot_dtype] == v0 + 1


@pytest.mark.parametrize("dot_dtype,k,d,b,c,t", VARIANT_FUSED)
def test_amp_unit_variant_matches_plain(cuda, gen, dot_dtype, k, d, b, c, t):
    c = {48: 48, 96: 192, 64: 160}[c]  # each of E's pass widths: 48, 96, 64
    x = _randn(gen, cuda, b, c, t, scale=0.5)
    acts = [_randn(gen, cuda, c, scale=0.3) for _ in range(4)]
    w1 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    w2 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    b1, b2 = _randn(gen, cuda, c, scale=0.1), _randn(gen, cuda, c, scale=0.1)
    ex = (_randn(gen, cuda, b, c, t),)
    args = (x, acts[0], acts[1], acts[2], acts[3], True, w1, b1, w2, b2)
    kw = dict(dilation=d, extra_residuals=ex, out_scale=0.5,
              dot_dtype=dot_dtype)
    v0 = ops.amp_unit.variant_launches[dot_dtype]
    cs = _chip_smoke()  # chip_smoke.py's tolerance of the variants
    cs._compare("amp_unit" + cs.suffix(dot_dtype), (b, c, t),
                ops.amp_unit(*args, **kw), ops.amp_unit_plain(*args, **kw))
    assert ops.amp_unit.variant_launches[dot_dtype] == v0 + 1


# The int8 instances of D and E on the s8 tensor cores compute the same
# integers as their plain versions (the activation in the plain version's
# order, the same windows and quanta, exact int32 sums) and the same f32
# epilogue, so they give the same bits: T off the 256-sample window, Cin
# off the 32-channel chunk, C = 48, a cluster of two (C = 192) and of a
# partial block (C = 160), a cluster of three 96-channel blocks (C = 200),
# and full-width stage shapes. (Cin, Cout, T, K, d, B) for D, (C, T, K,
# d, B) for E
INT8_PAIRS = [(45, 64, 777, 7, 3, 1), (48, 48, 300, 11, 5, 2),
              (384, 384, 600, 3, 1, 1), (768, 768, 5000, 11, 5, 1)]
INT8_UNITS = [(45, 777, 7, 3, 1), (48, 300, 11, 5, 2), (160, 777, 3, 1, 1),
              (192, 1000, 7, 3, 2), (192, 80000, 11, 5, 1),
              (200, 777, 7, 3, 1)]


@pytest.mark.parametrize("cin,cout,t,k,d,b", INT8_PAIRS)
def test_act_conv1d_int8_equals_plain(cuda, gen, cin, cout, t, k, d, b):
    x = _randn(gen, cuda, b, cin, t)
    a, be = _randn(gen, cuda, cin, scale=0.3), _randn(gen, cuda, cin, scale=0.3)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = (_randn(gen, cuda, b, cout, t),)
    args = (x, a, be, True, w, bias)
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=torch.int8)
    v0 = ops.act_conv1d.variant_launches[torch.int8]
    got = ops.act_conv1d(*args, **kw)
    assert ops.act_conv1d.variant_launches[torch.int8] == v0 + 1
    want = ops.act_conv1d_plain(*args, **kw)
    assert float((got - want).abs().max()) == 0.0 and torch.equal(got, want)


@pytest.mark.parametrize("c,t,k,d,b", INT8_UNITS)
def test_amp_unit_int8_equals_plain(cuda, gen, c, t, k, d, b):
    x = _randn(gen, cuda, b, c, t, scale=0.5)
    acts = [_randn(gen, cuda, c, scale=0.3) for _ in range(4)]
    w1 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    w2 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    b1, b2 = _randn(gen, cuda, c, scale=0.1), _randn(gen, cuda, c, scale=0.1)
    ex = (_randn(gen, cuda, b, c, t),)
    args = (x, *acts, True, w1, b1, w2, b2)
    kw = dict(dilation=d, extra_residuals=ex, out_scale=1.0 / 3,
              dot_dtype=torch.int8)
    v0 = ops.amp_unit.variant_launches[torch.int8]
    got = ops.amp_unit(*args, **kw)
    assert ops.amp_unit.variant_launches[torch.int8] == v0 + 1
    want = ops.amp_unit_plain(*args, **kw)
    assert float((got - want).abs().max()) == 0.0 and torch.equal(got, want)


# Kernel B.int8 (the GEMM route's s8 instance and its pre-pass) computes
# the plain version's integers (the same windows, quanta and exact int32
# sums) and its f32 epilogue in the same order, so it gives the same bits:
# T off the window and below one, Cin off the 32-channel chunk, Cout 48
# (48-channel tiles) and 40 (a partial tile), every K (d 5 at K 11), 0-3
# residuals, batch 2, and the widest stage. (B, Cin, Cout, T, K, d, n_res)
INT8_CONVS = [(2, 45, 40, 777, 3, 1, 0), (1, 48, 48, 100, 7, 3, 1),
              (2, 96, 96, 300, 11, 5, 2), (1, 64, 200, 512, 7, 1, 3),
              (1, 384, 384, 20000, 3, 3, 1), (1, 768, 768, 5000, 11, 5, 1)]


@pytest.mark.parametrize("b,cin,cout,t,k,d,n_res", INT8_CONVS)
def test_conv1d_int8_equals_plain(cuda, gen, b, cin, cout, t, k, d, n_res):
    x = _randn(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = tuple(_randn(gen, cuda, b, cout, t) for _ in range(n_res))
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=torch.int8)
    v0 = ops.conv1d.variant_launches[torch.int8]
    got = ops.conv1d(x, w, bias, **kw)
    assert ops.conv1d.variant_launches[torch.int8] == v0 + 1
    want = ops.conv1d_plain(x, w, bias, **kw)
    assert float((got - want).abs().max()) == 0.0 and torch.equal(got, want)


def test_conv_smem_arithmetic_matches_the_kernel(cuda):
    lib = _build.library("conv1d_same")
    for code, dt in enumerate((torch.float32, torch.bfloat16, torch.int8)):
        for c in (768, 384, 200, 192, 96, 48, 40):
            for k in (3, 7, 11):
                for d in (1, 3, 5):
                    assert lib.conv1d_same_smem_bytes(k, c, d, code) == \
                        ops.conv.conv_smem_bytes(k, d, c, dt)


def test_variant_wrappers_raise_without_an_instance(cuda, gen):
    x = _randn(gen, cuda, 1, 48, 64)
    with pytest.raises(ValueError, match="no kernel instance"):  # int8, Cout < 16
        ops.conv1d(x, _randn(gen, cuda, 1, 48, 7), None, dot_dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):  # upsamplers stay f32
        ops.conv_transpose1d(x, _randn(gen, cuda, 48, 24, 8), None, stride=4,
                             dot_dtype=torch.int8)
    with pytest.raises(ValueError, match="dot_dtype"):
        ops.conv1d(x, _randn(gen, cuda, 48, 48, 3), None,
                   dot_dtype=torch.float16)
    a = torch.zeros(48, device=cuda)
    with pytest.raises(ValueError):  # no K = 5 instance at any dtype
        ops.act_conv1d(x, a, None, True, _randn(gen, cuda, 48, 48, 5), None,
                       dilation=1, dot_dtype=torch.bfloat16)


@pytest.mark.parametrize("dot_dtype", [torch.bfloat16, torch.int8])
def test_reduced_precision_vocoder_on_card_matches_cpu(cuda, gen, dot_dtype):
    # every variant of the fused path launches as chip_smoke.py predicts,
    # and every launch agrees with its plain version on its own inputs. End
    # to end, the reduced-precision vocoder amplifies f32 rounding (a flipped
    # bf16 rounding or int8 quantum upstream moves everything after it), so
    # card against CPU is held to the CPU's own change under a nudge of the
    # mel by +-2^-16
    chip_smoke = _chip_smoke()
    cfg = VocoderConfig(upsample_initial_channel=1024)
    voc = seeded_init_(BigVGAN(cfg, conv_dtype=dot_dtype).eval(), 0)
    mel = _randn(gen, "cpu", 1, 8, cfg.num_mels)
    records = []
    with torch.inference_mode():
        want = voc(mel)
        floor = max(chip_smoke.rel_l2(voc(mel * (1 + s)), want)
                    for s in (2.0 ** -16, -2.0 ** -16))
        voc.to(cuda)
        ops.reset_launch_counts()
        got = voc(mel.to(cuda)).cpu()
        counts = chip_smoke.launch_counts()
        with chip_smoke.replayed(records):
            voc(mel.to(cuda))
    calls = chip_smoke.main_path_calls(cfg, 8, True, dot_dtype)
    assert counts == {k: sum(calls.get(k, {}).values()) for k in counts}
    sfx = chip_smoke.suffix(dot_dtype)
    assert all(counts[k + sfx] > 0 for k in ("act_conv1d", "amp_unit"))
    assert len(records) == sum(counts.values())
    assert torch.isfinite(got).all()
    assert chip_smoke.rel_l2(got, want) <= max(1e-2, 2 * floor)


# --- the instances on bf16 feature maps (storage_dtype bfloat16) -----------------

# Each takes bf16 x and residuals and returns bf16, computing as its
# float32-map instance on the widened values; its plain version rounds the
# same f32 function once. Where the two f32 results straddle a bf16 rounding
# boundary they come out one bf16 step apart (chip_smoke.BF16_FLIP_SHARE);
# the int8 instances give the same f32 bits, so the same bf16 bits. Odd T,
# T below one tile, B = 2, every route.
BF = torch.bfloat16


def _bf(gen, device, *shape, scale=1.0):
    return _randn(gen, device, *shape, scale=scale).to(BF)


def _storage_launches(fn, dot_dtype):
    return fn.storage_launches[dot_dtype]


def _close_bf16_maps(name, key, got, want, dot_dtype):
    assert got.dtype == want.dtype == BF
    if dot_dtype == torch.int8:
        assert torch.equal(got, want)
        return
    cs = _chip_smoke()
    cs._compare(name + cs.suffix(dot_dtype) + cs.BF16_MAPS, key, got, want)


@pytest.mark.parametrize("b,c,t", [(2, 48, 3001), (1, 768, 5000), (1, 4, 5),
                                   (1, 8, 1025), (1, 8, 3 * 1024 + 9),
                                   (1, 96, 4100), (86, 768, 13)])
def test_snake_kernel_on_bf16_maps_matches_plain(cuda, gen, b, c, t):
    x = _bf(gen, cuda, b, c, t)
    a, beta = _randn(gen, cuda, c, scale=0.3), _randn(gen, cuda, c, scale=0.3)
    n0 = _storage_launches(ops.snake_activation1d, torch.float32)
    got = ops.snake_activation1d(x, a, beta)
    assert _storage_launches(ops.snake_activation1d, torch.float32) == n0 + 1
    _close_bf16_maps("snake_aa", (b, c, t), got,
                     ops.snake_activation1d_plain(x, a, beta), torch.float32)
    # a row view one element in: no four-element access, the clamped path
    base = _bf(gen, cuda, 1 + 8 * 4100)
    xv = base[1:].view(1, 8, 4100)
    a8, b8 = _randn(gen, cuda, 8, scale=0.3), _randn(gen, cuda, 8, scale=0.3)
    _close_bf16_maps("snake_aa", "view", ops.snake_activation1d(xv, a8, b8),
                     ops.snake_activation1d_plain(xv, a8, b8), torch.float32)


# (B, Cin, Cout, T, K, d, n_res): the GEMM route (Cout >= 16) and the
# narrow one (conv_post, T % 4 == 0 and not)
BF16_MAP_CONVS = [(2, 48, 48, 777, 11, 5, 3), (1, 384, 384, 2001, 3, 1, 1),
                  (1, 96, 96, 3001, 7, 3, 2), (1, 40, 70, 257, 7, 3, 1),
                  (2, 48, 1, 4801, 7, 1, 0), (1, 48, 1, 4800, 7, 1, 0),
                  (1, 20, 3, 5, 5, 2, 1)]


# int8 has no narrow route: the vocoder keeps conv_post float32 under int8
@pytest.mark.parametrize("dot_dtype,b,cin,cout,t,k,d,n_res", [
    (dt,) + case for dt in (torch.float32, torch.bfloat16, torch.int8)
    for case in BF16_MAP_CONVS if dt != torch.int8 or case[2] >= 16])
def test_conv1d_on_bf16_maps_matches_plain(cuda, gen, dot_dtype, b, cin, cout,
                                           t, k, d, n_res):
    x = _bf(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = tuple(_bf(gen, cuda, b, cout, t) for _ in range(n_res))
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    n0 = _storage_launches(ops.conv1d, dot_dtype)
    got = ops.conv1d(x, w, bias, **kw)
    assert _storage_launches(ops.conv1d, dot_dtype) == n0 + 1
    _close_bf16_maps("conv1d_same", (b, cin, cout, t, k, d, n_res), got,
                     ops.conv1d_plain(x, w, bias, **kw), dot_dtype)


# (Cin, Cout, T, K, d, B) of kernel D at its tiles (256 x 64 in clusters,
# 128 x 128, 64 x 128) and (C, T, K, d, B) of kernel E (192 x 192, 96 and
# 48 x BN, 64 x 192 with a partial block)
BF16_MAP_PAIRS = [(768, 768, 293, 11, 5, 1), (384, 384, 777, 7, 3, 2),
                  (100, 96, 129, 11, 1, 1), (52, 48, 1, 3, 3, 1)]
BF16_MAP_UNITS = [(192, 293, 11, 5, 1), (96, 777, 7, 3, 2), (48, 3, 3, 1, 1),
                  (200, 777, 7, 3, 1)]


@pytest.mark.parametrize("cin,cout,t,k,d,b", BF16_MAP_PAIRS)
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_act_conv1d_on_bf16_maps_matches_plain(cuda, gen, dot_dtype, cin,
                                               cout, t, k, d, b):
    x = _bf(gen, cuda, b, cin, t)
    a, be = _randn(gen, cuda, cin, scale=0.3), _randn(gen, cuda, cin, scale=0.3)
    w = _randn(gen, cuda, cout, cin, k, scale=(cin * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    res = (_bf(gen, cuda, b, cout, t),)
    args = (x, a, be, True, w, bias)
    kw = dict(dilation=d, residuals=res, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    n0 = _storage_launches(ops.act_conv1d, dot_dtype)
    got = ops.act_conv1d(*args, **kw)
    assert _storage_launches(ops.act_conv1d, dot_dtype) == n0 + 1
    _close_bf16_maps("act_conv1d", (cin, cout, t, k, d, b), got,
                     ops.act_conv1d_plain(*args, **kw), dot_dtype)


@pytest.mark.parametrize("c,t,k,d,b", BF16_MAP_UNITS)
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_amp_unit_on_bf16_maps_matches_plain(cuda, gen, dot_dtype, c, t, k, d,
                                             b):
    x = _bf(gen, cuda, b, c, t, scale=0.5)
    acts = [_randn(gen, cuda, c, scale=0.3) for _ in range(4)]
    w1 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    w2 = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    b1, b2 = _randn(gen, cuda, c, scale=0.1), _randn(gen, cuda, c, scale=0.1)
    ex = (_bf(gen, cuda, b, c, t),)
    args = (x, *acts, True, w1, b1, w2, b2)
    kw = dict(dilation=d, extra_residuals=ex, out_scale=1.0 / 3,
              dot_dtype=dot_dtype)
    n0 = _storage_launches(ops.amp_unit, dot_dtype)
    got = ops.amp_unit(*args, **kw)
    assert _storage_launches(ops.amp_unit, dot_dtype) == n0 + 1
    _close_bf16_maps("amp_unit", (c, t, k, d, b), got,
                     ops.amp_unit_plain(*args, **kw), dot_dtype)


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
@pytest.mark.parametrize("fuse", [True, False])
def test_bf16_maps_vocoder_on_card_matches_cpu(cuda, gen, dot_dtype, fuse):
    # the instances on bf16 maps launch as chip_smoke.py predicts, each
    # launch agrees with its plain version on its own inputs, the maps
    # between the kernels are bf16 tensors, and the output stays within the
    # CPU's own change under a nudge of the mel by +-2^-16
    chip_smoke = _chip_smoke()
    cfg = VocoderConfig(upsample_initial_channel=1024)
    dt = None if dot_dtype == torch.float32 else dot_dtype
    voc = seeded_init_(BigVGAN(cfg, fuse_act_conv=fuse, conv_dtype=dt,
                               storage_dtype=BF).eval(), 0)
    mel = _randn(gen, "cpu", 1, 8, cfg.num_mels)
    records, seen = [], set()
    for m in voc.resblocks:
        m.register_forward_hook(lambda mod, i, o: seen.add((i[0].dtype,
                                                            o.dtype)))
    with torch.inference_mode():
        want = voc(mel)
        floor = max(chip_smoke.rel_l2(voc(mel * (1 + s)), want)
                    for s in (2.0 ** -16, -2.0 ** -16))
        voc.to(cuda)
        ops.reset_launch_counts()
        seen.clear()
        got = voc(mel.to(cuda)).cpu()
        counts = chip_smoke.launch_counts()
        with chip_smoke.replayed(records):
            voc(mel.to(cuda))
    assert seen == {(BF, BF)}
    calls = chip_smoke.main_path_calls(cfg, 8, fuse, dt, BF)
    assert counts == {k: sum(calls.get(k, {}).values()) for k in counts}
    assert all(counts[k] > 0 for k in calls if k.endswith("@bf16"))
    assert len(records) == sum(counts.values())
    assert torch.isfinite(got).all()
    assert chip_smoke.rel_l2(got, want) <= max(1e-2, 2 * floor)


# kernel C on bf16 maps (the vocoder's compute dtype bf16), both dot dtypes:
# the published upsamplers (Cin, Cout, u, K) at short T, odd and even, and
# the edge shapes of CONVT_SHAPES at every instance
CONVT_PUBLISHED = [(1536, 768, 5, 11), (768, 384, 4, 8), (384, 192, 4, 8),
                   (192, 96, 3, 7), (96, 48, 2, 4)]


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,t,u,k", [
    (1, cin, cout, t, u, k) for cin, cout, u, k in CONVT_PUBLISHED
    for t in (37, 64)] + [
    case + pair for case in CONVT_SHAPES for pair in CONVT_INSTANCES])
def test_conv_transpose1d_on_bf16_maps_matches_plain(cuda, gen, dot_dtype, b,
                                                     cin, cout, t, u, k):
    x = _bf(gen, cuda, b, cin, t)
    w = _randn(gen, cuda, cin, cout, k, scale=(cout * k) ** -0.5)
    bias = _randn(gen, cuda, cout, scale=0.1)
    kw = dict(stride=u, dot_dtype=dot_dtype)
    n0 = _storage_launches(ops.conv_transpose1d, dot_dtype)
    got = ops.conv_transpose1d(x, w, bias, **kw)
    assert _storage_launches(ops.conv_transpose1d, dot_dtype) == n0 + 1
    assert got.shape == (b, cout, u * t)
    _close_bf16_maps("conv_transpose1d", (b, cin, cout, t, u, k), got,
                     ops.conv_transpose1d_plain(x, w, bias, **kw), dot_dtype)


def test_conv_transpose1d_on_bf16_maps_refuses_autograd(cuda, gen):
    # C on bf16 maps stands for the Pallas kernel, which jax.grad refuses
    x = _bf(gen, cuda, 1, 48, 40)
    wt = _randn(gen, cuda, 48, 24, 8, scale=0.1).requires_grad_()
    for dot_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="Linearization failed"):
            ops.conv_transpose1d(x, wt, None, stride=4, dot_dtype=dot_dtype)
        with torch.no_grad():
            assert ops.conv_transpose1d(x, wt, None, stride=4,
                                        dot_dtype=dot_dtype).dtype == BF


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_bf16_compute_vocoder_on_card_matches_cpu(cuda, gen, dot_dtype):
    # BigVGAN(dtype=bf16): the launches chip_smoke.py predicts (kernel C on
    # bf16 maps at every upsampler), each launch against its plain version
    # on its own inputs, C's outputs (the resblocks' inputs) bf16 tensors,
    # and the output within the
    # CPU's own change under a nudge of the mel by +-2^-16
    chip_smoke = _chip_smoke()
    cfg = VocoderConfig(upsample_initial_channel=1024)
    dt = None if dot_dtype == torch.float32 else dot_dtype
    voc = seeded_init_(BigVGAN(cfg, conv_dtype=dt, dtype=BF).eval(), 0)
    mel = _randn(gen, "cpu", 1, 8, cfg.num_mels)
    records, seen = [], set()
    for m in voc.resblocks:  # their input: the upsampler's output
        m.register_forward_pre_hook(lambda mod, i: seen.add(i[0].dtype))
    with torch.inference_mode():
        want = voc(mel)
        floor = max(chip_smoke.rel_l2(voc(mel * (1 + s)), want)
                    for s in (2.0 ** -16, -2.0 ** -16))
        voc.to(cuda)
        ops.reset_launch_counts()
        got = voc(mel.to(cuda)).cpu()
        counts = chip_smoke.launch_counts()
        with chip_smoke.replayed(records):
            voc(mel.to(cuda))
    calls = chip_smoke.main_path_calls(cfg, 8, True, dt, None, BF)
    assert counts == {k: sum(calls.get(k, {}).values()) for k in counts}
    convt = "conv_transpose1d" + chip_smoke.suffix(
        dt if dt == BF else None) + "@bf16"
    assert counts[convt] == 5 and seen == {BF}
    assert len(records) == sum(counts.values())
    assert torch.isfinite(got).all()
    assert chip_smoke.rel_l2(got, want) <= max(1e-2, 2 * floor)


# --- the probe kernels G, H and kernel A's firs-only instance ------------------

@pytest.mark.parametrize("b,s,lanes", [(1, 600, 384), (2, 37, 64), (1, 9, 10)])
def test_snake_only_kernel_matches_plain(cuda, gen, b, s, lanes):
    # L % 4 == 0 takes the 16-byte path, L = 10 the scalar one
    x = _randn(gen, cuda, b, s, lanes, scale=0.3)
    ab = torch.exp(_randn(gen, cuda, 2, lanes, scale=0.1))
    n0 = ops.snake_only.launches
    _close(ops.snake_only(x, ab), ops.snake_only_plain(x, ab))
    assert ops.snake_only.launches == n0 + 1


@pytest.mark.parametrize("b,c,t", [(2, 48, 3000), (1, 4, 5), (1, 8, 4100),
                                   (1, 4, 1), (70, 1000, 13)])
def test_act_firs_only_kernel_matches_plain(cuda, gen, b, c, t):
    x = _randn(gen, cuda, b, c, t)
    n0 = ops.act_firs_only.launches
    _close(ops.act_firs_only(x), ops.act_firs_only_plain(x))
    assert ops.act_firs_only.launches == n0 + 1


def _mxu_inputs(gen, device, b, s, lanes, dtype):
    x = _randn(gen, device, b, s, lanes, scale=0.3)
    up = _randn(gen, device, 3, lanes, 2 * lanes).to(dtype)
    dn = _randn(gen, device, 3, 2 * lanes, lanes).to(dtype)
    ab2 = torch.exp(_randn(gen, device, 2, 2 * lanes, scale=0.1))
    return x, up, dn, ab2


def _close_max_normalised(got, want):
    # values reach a few hundred: atol / rtol 1e-4 on got / max|want|
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=1e-4)


# kernel H's row tiles (csrc/probe_fir.cu): 62 output rows a block (f32),
# 126 a cluster of two blocks (bf16); S is a multiple of 8 (the JAX
# kernel's row blocks), so the rows next to a tile edge are 8 away
H_TILE_F32, H_TILE_BF16 = 62, 126
MXU_FIR_CASES = [
    (2, 128, 64), (1, 200, 128), (1, 512, 384),
    (1, 8, 384),                                  # one block, 8 rows
    (3, 4 * H_TILE_F32 + 8, 192),                 # B = 3, past an f32 edge
    (1, 4 * H_TILE_F32, 256),                     # whole f32 tiles
    (2, 4 * H_TILE_BF16, 64),                     # whole bf16 tiles
    (1, 4 * H_TILE_BF16 - 8, 384), (1, 4 * H_TILE_BF16 + 8, 384)]


@pytest.mark.parametrize("b,s,lanes", MXU_FIR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("do_snake", [True, False])
def test_mxu_fir_kernel_matches_plain(cuda, gen, b, s, lanes, dtype, do_snake):
    x, up, dn, ab2 = _mxu_inputs(gen, cuda, b, s, lanes, dtype)
    inst = probes.mxu_fir_instance(dtype, do_snake)
    n0, i0 = ops.mxu_fir.launches, ops.mxu_fir.instance_launches[inst]
    got = ops.mxu_fir(x, up, dn, ab2, do_snake=do_snake)
    want = ops.mxu_fir_plain(x, up, dn, ab2, do_snake=do_snake)
    assert ops.mxu_fir.launches == n0 + 1
    assert ops.mxu_fir.instance_launches[inst] == i0 + 1
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        _close_max_normalised(got, want)
    else:
        # a flipped bf16 rounding of s2 (kernel and plain sum in other
        # orders) moves an output row by a bf16 step times dn
        d = (got - want).double()
        assert d.norm() / want.double().norm() <= 1e-3
        assert d.abs().max() <= 1e-2 * max(1.0, float(want.abs().max()))


def test_mxu_fir_wrapper_rejects_what_the_kernel_does_not_take(cuda, gen):
    for lanes in (32, 448):
        x, up, dn, ab2 = _mxu_inputs(gen, cuda, 1, 64, lanes, torch.float32)
        with pytest.raises(ValueError, match="L % 64"):
            ops.mxu_fir(x, up, dn, ab2)
    x, up, dn, ab2 = _mxu_inputs(gen, cuda, 1, 64, 64, torch.float32)
    shifted = torch.empty(up.numel() + 1, device=cuda)[1:].view(up.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.mxu_fir(x, shifted.copy_(up), dn, ab2)


# --- the CLI's --tiny vocoder: odd (K - u) upsamplers on the library conv ------

def test_tiny_vocoder_on_card_routes_odd_upsamplers_to_the_library(cuda, gen):
    from flowhigh_tpu_torch.cli import tiny_config
    cfg = tiny_config().vocoder  # (u, K): (8, 16) (5, 10) (4, 8) (3, 6)
    voc = seeded_init_(BigVGAN(cfg).eval(), 0)
    mel = _randn(gen, "cpu", 1, 12, cfg.num_mels)
    with torch.inference_mode():
        want = voc(mel)
        voc.to(cuda)
        ops.reset_launch_counts()
        BigVGAN.library_upsamplers = 0
        got = voc(mel.to(cuda)).cpu()
    assert ops.conv_transpose1d.launches == 2  # (8, 16), (4, 8)
    assert BigVGAN.library_upsamplers == 2     # (5, 10), (3, 6)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# --- the sosfilt kernel: the device sosfiltfilt's IIR pass -------------------------

# (rows, samples, sections, reverse): one row, a part warp, more than one
# block of 32 rows; fewer samples than a chunk of 8, one more than a chunk;
# every instance S = 1..8
SOSFILT_CASES = [(1, 1, 1, False), (3, 7, 2, True), (33, 9, 3, False),
                 (70, 600, 4, True), (2, 1000, 5, False), (5, 777, 6, True),
                 (32, 300, 7, False), (4, 513, 8, True)]


def _cascade_of(n_sec):
    import scipy.signal as sps

    from flowhigh_tpu_torch.ops.iir import cascade
    sos = sps.cheby1(2 * n_sec, 1.0, 0.3, btype="lowpass", output="sos")
    return cascade(sos, sps.sosfilt_zi(sos))


@pytest.mark.parametrize("rows,t,n_sec,reverse", SOSFILT_CASES)
def test_sosfilt_kernel_matches_plain(cuda, gen, rows, t, n_sec, reverse):
    # both round every product and sum on its own in the scan's order
    from flowhigh_tpu_torch.ops.iir import sosfilt_plain
    coefs = _cascade_of(n_sec)
    x = _randn(gen, cuda, rows, t)
    n0 = ops.sosfilt.launches
    got = ops.sosfilt(coefs, x, reverse=reverse)
    torch.cuda.synchronize()
    assert ops.sosfilt.launches == n0 + 1
    torch.testing.assert_close(got, sosfilt_plain(coefs, x, reverse),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("order,ripple,wn", [(1, 1e-9, 0.5), (8, 0.05, 1 / 3),
                                             (11, 5.0, 1 / 12)])
def test_sosfiltfilt_on_card_matches_cpu_and_scipy(cuda, gen, order, ripple,
                                                   wn):
    import scipy.signal as sps

    from flowhigh_tpu_torch.dsp import cheby1_sos, sosfiltfilt
    sos = cheby1_sos(order, ripple, wn)
    x = (0.5 * gen.standard_normal((2, 4000))).astype(np.float32)
    n0 = ops.sosfilt.launches
    got = sosfiltfilt(sos, torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert ops.sosfilt.launches == n0 + 2  # forward, then reverse
    plain = sosfiltfilt(sos, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    # tests/test_dsp.py's bound for the JAX function
    np.testing.assert_allclose(got, sps.sosfiltfilt(sos, x.astype(np.float64)),
                               atol=2e-3)


def test_sosfilt_wrapper_rejects_what_the_kernel_does_not_take(cuda, gen):
    coefs = _cascade_of(2)
    x = _randn(gen, cuda, 4, 100)
    with pytest.raises(ValueError, match="sections"):
        ops.sosfilt(np.concatenate([coefs] * 5), x)  # 10 > 8 sections
    with pytest.raises(ValueError, match="contiguous"):
        ops.sosfilt(coefs, x.t())
    with pytest.raises(ValueError, match="float32"):
        ops.sosfilt(coefs, x.double())
    with pytest.raises(ValueError, match="coefs"):
        ops.sosfilt(coefs[:, :6], x)


# --- gradients: kernels A, B and C carry one, D, E and the reduced-precision
# instances refuse one (vocoder GAN training) ----------------------------------

# the published generator's stages at a 32-frame segment (batch 2 here):
# (C, T) of each stage's maps
GRAD_STAGES = [(768, 160), (384, 640), (192, 2560), (96, 7680), (48, 15360)]


def _leaves(tensors):
    return [None if t is None else t.detach().clone().requires_grad_()
            for t in tensors]


def _grads_close(fn, plain, tensors, g):
    """fn and plain under autograd on the same leaves and output gradient:
    the outputs within the kernel's tolerance, every gradient within rel L2
    1e-5 and max abs 1e-5 x its largest |value| of the plain version's
    (the backward is the plain version's VJP; cuDNN sums a weight
    gradient's B T products in an order of its own at each call)."""
    from flowhigh_tpu_torch.utils import cudnn_f32
    a, b = _leaves(tensors), _leaves(tensors)
    ya, yb = fn(*a), plain(*b)
    assert ya.grad_fn is not None
    _close(ya, yb)
    with cudnn_f32():  # the plain version's VJP in f32, as its forward
        ya.backward(g)
        yb.backward(g)
    for ta, tb in zip(a, b):
        if ta is not None:
            diff = (ta.grad - tb.grad).double()
            assert float(diff.norm() / tb.grad.double().norm()) <= 1e-5
            assert float(diff.abs().max()) <= 1e-5 * float(
                tb.grad.abs().max())


@pytest.mark.parametrize("c,t", GRAD_STAGES)
@pytest.mark.parametrize("with_beta", [True, False])
def test_snake_kernel_gradient_is_the_plain_vjp(cuda, gen, c, t, with_beta):
    x = _randn(gen, cuda, 2, c, t)
    ab = [_randn(gen, cuda, c, scale=0.3),
          _randn(gen, cuda, c, scale=0.3) if with_beta else None]
    n0 = ops.snake_activation1d.launches
    _grads_close(lambda x, a, b: ops.snake_activation1d(x, a, b),
                 lambda x, a, b: ops.snake_activation1d_plain(x, a, b),
                 [x] + ab, _randn(gen, cuda, 2, c, t))
    assert ops.snake_activation1d.launches == n0 + 1


@pytest.mark.parametrize("c,t", GRAD_STAGES)
@pytest.mark.parametrize("k,d,n_res,out_scale", [(3, 1, 1, 1.0),
                                                 (11, 5, 3, 1 / 3),
                                                 (7, 3, 2, 1.0)])
def test_conv1d_kernel_gradient_is_the_plain_vjp(cuda, gen, c, t, k, d,
                                                 n_res, out_scale):
    x = _randn(gen, cuda, 2, c, t)
    w = _randn(gen, cuda, c, c, k, scale=(c * k) ** -0.5)
    bias = _randn(gen, cuda, c, scale=0.1)
    res = [_randn(gen, cuda, 2, c, t) for _ in range(n_res)]
    n0 = ops.conv1d.launches
    _grads_close(
        lambda x, w, b, *r: ops.conv1d(x, w, b, dilation=d, residuals=r,
                                       out_scale=out_scale),
        lambda x, w, b, *r: ops.conv1d_plain(x, w, b, dilation=d,
                                             residuals=r,
                                             out_scale=out_scale),
        [x, w, bias] + res, _randn(gen, cuda, 2, c, t))
    assert ops.conv1d.launches == n0 + 1


def test_conv_post_kernel_gradient_is_the_plain_vjp(cuda, gen):
    # the narrow route (Cout = 1 < 16), at the last stage's width
    x = _randn(gen, cuda, 2, 48, 15360)
    w = _randn(gen, cuda, 1, 48, 7, scale=(48 * 7) ** -0.5)
    _grads_close(lambda x, w, b: ops.conv1d(x, w, b),
                 lambda x, w, b: ops.conv1d_plain(x, w, b),
                 [x, w, _randn(gen, cuda, 1)], _randn(gen, cuda, 2, 1, 15360))


@pytest.mark.parametrize("cin,t,u,k", [(1536, 32, 5, 11), (768, 160, 4, 8),
                                       (384, 640, 4, 8), (192, 2560, 3, 7),
                                       (96, 7680, 2, 4)])
def test_conv_transpose1d_kernel_gradient_is_the_plain_vjp(cuda, gen, cin, t,
                                                           u, k):
    x = _randn(gen, cuda, 2, cin, t)
    w = _randn(gen, cuda, cin, cin // 2, k, scale=(cin * k / u) ** -0.5)
    n0 = ops.conv_transpose1d.launches
    _grads_close(lambda x, w, b: ops.conv_transpose1d(x, w, b, stride=u),
                 lambda x, w, b: ops.conv_transpose1d_plain(x, w, b,
                                                            stride=u),
                 [x, w, _randn(gen, cuda, cin // 2, scale=0.1)],
                 _randn(gen, cuda, 2, cin // 2, u * t))
    assert ops.conv_transpose1d.launches == n0 + 1


def test_no_grad_calls_launch_directly(cuda, gen):
    """Without a gradient (no_grad, inference_mode, or nothing that
    requires one) the wrappers launch as before: no autograd node; with
    one they launch once inside their Function."""
    x = _randn(gen, cuda, 2, 96, 700)
    w = torch.nn.Parameter(_randn(gen, cuda, 96, 96, 3, scale=0.1))
    a = torch.nn.Parameter(_randn(gen, cuda, 96, scale=0.3))
    wt = torch.nn.Parameter(_randn(gen, cuda, 96, 48, 4, scale=0.1))
    calls = {ops.snake_activation1d: lambda: ops.snake_activation1d(x, a, a),
             ops.conv1d: lambda: ops.conv1d(x, w, None),
             ops.conv_transpose1d: lambda: ops.conv_transpose1d(x, wt, None,
                                                                stride=2)}
    for fn, call in calls.items():
        for ctx in (torch.no_grad, torch.inference_mode):
            n0 = fn.launches
            with ctx():
                assert call().grad_fn is None
            assert fn.launches == n0 + 1
        n0 = fn.launches
        assert "Grad" in type(call().grad_fn).__name__
        assert fn.launches == n0 + 1


def test_adam_step_moves_the_kernels_weight_layouts(cuda, gen):
    """Kernels B and C read a weight layout cached by the tensor's version
    counter: after an in-place step of the vocoder trainer's Adam their
    outputs equal their plain versions with the new weights."""
    from flowhigh_tpu_torch.train import VocoderTrainer
    x = _randn(gen, cuda, 2, 96, 700)
    w = torch.nn.Parameter(_randn(gen, cuda, 96, 96, 3, scale=0.1))
    wt = torch.nn.Parameter(_randn(gen, cuda, 96, 48, 4, scale=0.1))
    opt = VocoderTrainer(device=cuda)._adam([w, wt])
    for _ in range(2):
        with torch.no_grad():  # fills the caches
            ops.conv1d(x, w, None)
            ops.conv_transpose1d(x, wt, None, stride=2)
        loss = (ops.conv1d(x, w, None).square().mean()
                + ops.conv_transpose1d(x, wt, None, stride=2).square().mean())
        opt.zero_grad()
        loss.backward()
        before = (w.detach().clone(), wt.detach().clone())
        opt.step()
        assert not torch.equal(before[0], w) and not torch.equal(before[1],
                                                                 wt)
        with torch.no_grad():
            _close(ops.conv1d(x, w, None), ops.conv1d_plain(x, w, None))
            _close(ops.conv_transpose1d(x, wt, None, stride=2),
                   ops.conv_transpose1d_plain(x, wt, None, stride=2))


def test_pallas_only_instances_refuse_autograd(cuda, gen):
    """D, E and every reduced-precision instance stand for Pallas kernels,
    which JAX cannot differentiate: under autograd they raise the JAX
    package's error; without a gradient they run."""
    c, t = 192, 700
    x = _randn(gen, cuda, 1, c, t)
    a = _randn(gen, cuda, c, scale=0.3).requires_grad_()
    w = _randn(gen, cuda, c, c, 3, scale=c ** -0.5).requires_grad_()
    wt = _randn(gen, cuda, c, c // 2, 4, scale=0.1).requires_grad_()
    xb = x.bfloat16()
    refusals = [
        lambda: ops.act_conv1d(x, a, a, True, w, None, dilation=1),
        lambda: ops.amp_unit(x, a, a, a, a, True, w, None, w, None,
                             dilation=1),
        lambda: ops.conv1d(x, w, None, dot_dtype=torch.bfloat16),
        lambda: ops.conv1d(x, w, None, dot_dtype=torch.int8),
        lambda: ops.conv1d(xb, w, None),
        lambda: ops.conv_transpose1d(x, wt, None, stride=2,
                                     dot_dtype=torch.bfloat16),
        lambda: ops.snake_activation1d(xb, a, a)]
    for call in refusals:
        with pytest.raises(ValueError, match="Linearization failed"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call().float()).all()


def test_vocoder_trainer_steps_on_the_card(cuda):
    """The tiny GAN trainer on the card: every parameter gets a gradient,
    the generator runs kernels A, B and C (and neither D nor E), and the
    losses are finite."""
    from flowhigh_tpu_torch.train import VocoderTrainer
    tr = VocoderTrainer(VocoderConfig(
        upsample_initial_channel=64, upsample_rates=(8, 5, 4, 3),
        upsample_kernel_sizes=(16, 11, 8, 7), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),)), segment_frames=8, periods=(2,),
        resolutions=((512, 50, 240),), device=cuda)
    state = tr.init_state(0)
    wave = torch.randn(2, tr.segment_samples,
                       generator=torch.Generator().manual_seed(0)) * 0.3
    ops.reset_launch_counts()
    state, m = tr.train_step(state, {"wave": wave})
    for mod in (state.generator, state.mpd, state.mrd):
        for name, p in mod.named_parameters():
            assert p.grad is not None, name
    counts = [fn.launches for fn in ops.KERNELS]
    assert all(counts[:3]) and counts[3:] == [0, 0, 0]
    assert all(torch.isfinite(v) for v in m.values())


def test_trainer_on_a_nccl_mesh_of_one_matches_one_card(cuda, monkeypatch):
    """``Trainer(mesh=make_mesh())`` at world size 1 over NCCL (torchrun's
    environment set here on loopback) takes the same update as
    ``Trainer()`` from the same weights and draws: DDP's all-reduce over one
    rank and the loss's mean over ``data`` change nothing."""
    import socket

    import torch.distributed as dist

    from flowhigh_tpu_torch import parallel
    from flowhigh_tpu_torch.cfm import draw_training
    from flowhigh_tpu_torch.config import (FlowHighConfig, ModelConfig,
                                           TrainConfig)
    from flowhigh_tpu_torch.train import Trainer
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    cfg = FlowHighConfig().replace(
        model=ModelConfig(dim_in=256, dim=64, depth=2, heads=2, dim_head=16),
        train=TrainConfig(batch_size=2, num_warmup_steps=0,
                          cond_freq_masking=True, amp_dtype="float32"))
    gen = np.random.default_rng(0)
    wave = (0.3 * gen.standard_normal((2, 48000))).astype(np.float32)
    batch = {"wave": wave, "cond": 0.5 * wave, "lengths": np.full(2, 48000)}
    draws = draw_training(torch.Generator(cuda).manual_seed(1),
                          (2, 100, 256), cuda)
    one = Trainer(cfg, device=cuda)
    s1, m1 = one.train_step(one.init_state(0), batch, draws=draws)
    assert parallel.initialize() == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        tr = Trainer(cfg, mesh=parallel.make_mesh())
        s2 = tr.init_state(0)
        assert s2.ddp is not None and s2.net.to_pred.weight.is_cuda
        s2, m2 = tr.train_step(s2, batch, draws=draws)
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    for (name, p), q in zip(s2.net.named_parameters(), s1.net.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
