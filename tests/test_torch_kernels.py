"""flowhigh_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and nvcc (the kernels have
no CPU mode) and skips without one. This file imports no JAX, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda
"""

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
    # kernel A then kernel B, summed in the same order
    chain = ops.conv1d(ops.snake_activation1d(*args[:4]), w, args[5], **kw)
    torch.testing.assert_close(got, chain, atol=1e-6, rtol=0)


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


def test_fused_smem_arithmetic_matches_the_kernels(cuda):
    lib_d, lib_e = _build.library("act_conv1d"), _build.library("amp_unit")
    for c in (768, 384, 192, 96, 48):
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                assert lib_d.act_conv1d_smem_bytes(k, d, c) == \
                    fused_conv.act_conv_smem_bytes(k, d, c)
                assert lib_e.amp_unit_smem_bytes(k, d, c) == \
                    fused_conv.amp_unit_smem_bytes(k, d, c)


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
        # the kernel's running softmax against a dense one, both in f32
        torch.testing.assert_close(
            got, ops.flash_attention_plain(q, k, v, m, 10.0),
            atol=1e-4, rtol=1e-4)
    assert ops.flash_attention.launches == n0 + 2


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


@pytest.mark.parametrize("u,k", UPSAMPLERS)
def test_conv_transpose1d_bf16_matches_plain(cuda, gen, u, k):
    x = _randn(gen, cuda, 2, 40, 101)
    w = _randn(gen, cuda, 40, 24, k, scale=(24 * k) ** -0.5)
    bias = _randn(gen, cuda, 24)
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


# --- the probe kernels G, H and kernel A's firs-only instance ------------------

@pytest.mark.parametrize("b,s,lanes", [(1, 600, 384), (2, 37, 64), (1, 9, 10)])
def test_snake_only_kernel_matches_plain(cuda, gen, b, s, lanes):
    # L % 4 == 0 takes the 16-byte path, L = 10 the scalar one
    x = _randn(gen, cuda, b, s, lanes, scale=0.3)
    ab = torch.exp(_randn(gen, cuda, 2, lanes, scale=0.1))
    n0 = ops.snake_only.launches
    _close(ops.snake_only(x, ab), ops.snake_only_plain(x, ab))
    assert ops.snake_only.launches == n0 + 1


@pytest.mark.parametrize("b,c,t", [(2, 48, 3000), (1, 4, 5)])
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


@pytest.mark.parametrize("b,s,lanes", [(2, 128, 64), (1, 200, 128),
                                       (1, 512, 384)])
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
