"""The port's reduced-precision vocoder (``dot_dtype`` / ``vocoder_conv_dtype``
bfloat16 and int8) against the JAX package's Pallas kernels in interpret
mode on the CPU: each plain version computes what its Pallas counterpart
computes under the same ``dot_dtype``. The kernels themselves need the
card: tests/test_torch_kernels.py holds them against these plain versions;
tests/test_torch_dot_dtype_vocoder.py holds the whole vocoder and
``generate`` against the JAX package's.

bfloat16 is exact up to f32 summation order: a bf16 x bf16 product is
exact in f32. int8 quantises each activation with one scale per window;
the port's window is its kernel's tile, the JAX package's the TPU tile
(``ops/quant.py``), so the two agree to f32 rounding only where one window
covers the whole sequence on both sides (packed p in {8, 4, 2} within the
JAX plans' row caps); at longer sequences each is held to the JAX tests'
own bound of the f32 result (tests/test_packed.py::TestInt8Dots)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowhigh_tpu.ops.packed import (pack_time, pallas_packed_act_conv1d,
                                     pallas_packed_amp_unit,
                                     pallas_packed_conv1d,
                                     pallas_packed_conv_transpose1d,
                                     unpack_time)
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat import seeded_init_
from flowhigh_tpu_torch.models import BigVGAN
from flowhigh_tpu_torch.ops import quant

JDT = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}
UPSAMPLERS = [(5, 11), (4, 8), (3, 7), (2, 4)]  # BigVGAN's (u, K) pairs


def _btc(x):  # port [B, C, T] <-> JAX [B, T, C]
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


def _packed(x, p):  # port [B, C, T] -> JAX packed [B, T/p, p*C]
    return pack_time(jnp.asarray(_btc(x)), p)


def _unpacked(y, p):  # JAX packed -> port [B, C, T]
    return _btc(unpack_time(y, p))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _hio(w):  # [Cout, Cin, K] -> [K, Cin, Cout]
    return jnp.asarray(w.transpose(2, 1, 0))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _params(rng, c, k, scale_w=0.05):
    f32 = np.float32
    return dict(alpha=(rng.standard_normal(c) * 0.2).astype(f32),
                beta=(rng.standard_normal(c) * 0.2).astype(f32),
                w=(rng.standard_normal((c, c, k)) * scale_w).astype(f32),
                b=(rng.standard_normal(c) * 0.1).astype(f32))


def _stat_close(got, want, rel_l2, max_abs):
    """bf16 D and E: an f32 ulp of the snake can move an activation across
    a bf16 rounding boundary, which moves an output by one bf16 step of the
    weight's product; bounded in relative L2 and max, the flips counted."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flips = int((diff > 1e-4).sum())
    print(f"rel L2 {_rel(got, want):.3e}, max abs {diff.max():.3e}, "
          f"{flips} of {diff.size} elements beyond 1e-4")
    assert _rel(got, want) <= rel_l2 and diff.max() <= max_abs


# --- the quantisation rules ------------------------------------------------------

def test_quantize_weights_is_the_jax_rule(rng):
    from flowhigh_tpu.ops.packed import _quant_weights_per_cout
    w = (rng.standard_normal((24, 16, 7)) * 0.1).astype(np.float32)
    w[3] = 0.0  # an all-zero channel: the 1e-30 floor
    wq, s_w = quant.quantize_weights(torch.from_numpy(w))
    jq, js = _quant_weights_per_cout(jnp.asarray(w.transpose(2, 1, 0)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq).transpose(2, 1, 0))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js))


def test_windows_cover_the_partition():
    a = torch.arange(10.0).reshape(1, 1, 10)
    win = quant.windows(a, -2, 8, 4, 3)  # tiles of 4 with a reach of 2
    assert win.shape == (1, 3, 1, 8)
    assert win[0, :, 0].tolist() == [[0, 0, 0, 1, 2, 3, 4, 5],
                                      [2, 3, 4, 5, 6, 7, 8, 9],
                                      [6, 7, 8, 9, 0, 0, 0, 0]]
    y = torch.arange(12.0).reshape(1, 3, 1, 4)
    assert quant.untile(y, 10)[0, 0].tolist() == list(range(10))


def test_int8_conv_takes_one_scale_per_window(rng):
    # a loud tile does not coarsen a quiet one's quantisation
    x = rng.standard_normal((1, 8, 512)).astype(np.float32) * 0.01
    x[:, :, 300:] *= 1000.0
    w = rng.standard_normal((16, 8, 3)).astype(np.float32)
    ref = ops.conv1d_plain(_t(x), _t(w), None)
    tiled = ops.conv1d_plain(_t(x), _t(w), None, dot_dtype=torch.int8)
    whole = ops.conv1d_plain(_t(x), _t(w), None, dot_dtype=torch.int8,
                             tile=512)
    quiet = slice(0, 200)
    assert (_rel(tiled[..., quiet], ref[..., quiet]) * 20
            < _rel(whole[..., quiet], ref[..., quiet]))


def test_weight_cache_follows_the_weights():
    voc_cfg = pcfg.VocoderConfig(num_mels=8, upsample_initial_channel=16,
                                 upsample_rates=(2,), upsample_kernel_sizes=(4,),
                                 resblock_kernel_sizes=(3,),
                                 resblock_dilation_sizes=((1,),))
    voc = seeded_init_(BigVGAN(voc_cfg, conv_dtype=torch.int8).eval(), 0)
    w = voc.resblocks[0].convs1[0].weight
    first = quant.int8_weights(w)
    assert quant.int8_weights(w) is first                   # cached
    seeded_init_(voc, 1)                                    # in place
    wq, s_w = quant.int8_weights(w)
    np.testing.assert_array_equal(wq.numpy(),
                                  quant.quantize_weights(w.detach())[0].numpy())
    assert not torch.equal(wq, first[0])
    other = seeded_init_(BigVGAN(voc_cfg, conv_dtype=torch.int8).eval(), 2)
    voc.load_state_dict(other.state_dict())                 # in place
    assert torch.equal(quant.int8_weights(w)[1],
                       quant.quantize_weights(w.detach())[1])
    b16 = quant.bf16_weights(w)
    with torch.no_grad():
        w.mul_(2.0)
    assert torch.equal(quant.bf16_weights(w), quant.round_bf16(w.detach()))
    assert not torch.equal(quant.bf16_weights(w), b16)
    with torch.inference_mode():  # inference tensors are prepared anew
        wi = w.detach().clone()
        assert torch.equal(quant.int8_weights(wi)[0],
                           quant.quantize_weights(wi)[0])


# --- kernel B (conv1d) and C (conv_transpose1d): bfloat16 -------------------------

@pytest.mark.parametrize("cin,cout,k,d,n_res,scale", [
    (16, 16, 3, 1, 0, 1.0), (16, 24, 7, 3, 1, 1.0), (16, 16, 11, 5, 3, 1 / 3),
    (48, 1, 7, 1, 0, 1.0)])  # the last: conv_post
def test_conv1d_bf16_plain_matches_pallas(rng, cin, cout, k, d, n_res, scale):
    t = 160
    x = rng.standard_normal((1, cin, t)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k)) / np.sqrt(cin * k)).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = [rng.standard_normal((1, cout, t)).astype(np.float32)
           for _ in range(n_res)]
    want = np.asarray(pallas_packed_conv1d(
        jnp.asarray(_btc(x)), _hio(w), jnp.asarray(b), pad=d * (k - 1) // 2,
        dilation=d, p=1, residual=[jnp.asarray(_btc(r)) for r in res] or None,
        out_scale=scale, dot_dtype=jnp.bfloat16, interpret=True))
    got = ops.conv1d_plain(_t(x), _t(w), _t(b), dilation=d,
                           residuals=[_t(r) for r in res], out_scale=scale,
                           dot_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=1e-5, rtol=0)
    f32 = ops.conv1d_plain(_t(x), _t(w), _t(b), dilation=d,
                           residuals=[_t(r) for r in res],
                           out_scale=scale).numpy()
    assert np.abs(got - f32).max() > 1e-4  # the operands were rounded


@pytest.mark.parametrize("u,k", UPSAMPLERS)
def test_conv_transpose1d_bf16_plain_matches_pallas(rng, u, k):
    cin, cout, t = 16, 8, 40
    x = rng.standard_normal((1, cin, t)).astype(np.float32)
    w = (rng.standard_normal((cin, cout, k)) / np.sqrt(cout * k)).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.asarray(pallas_packed_conv_transpose1d(
        jnp.asarray(_btc(x)), jnp.asarray(w.transpose(2, 1, 0)),
        jnp.asarray(b), stride=u, padding=(k - u) // 2, p_in=1, p_out=1,
        dot_dtype=jnp.bfloat16, interpret=True))
    got = ops.conv_transpose1d_plain(_t(x), _t(w), _t(b), stride=u,
                                     dot_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=1e-5, rtol=0)


def test_conv_transpose1d_has_no_int8():
    x = torch.zeros(1, 8, 10)
    with pytest.raises(ValueError, match="int8"):
        ops.conv_transpose1d(x, torch.zeros(8, 4, 8), None, stride=4,
                             dot_dtype=torch.int8)


# --- int8 at one window: kernel B, D, E against the JAX kernels --------------------

@pytest.mark.parametrize("p,c,k,d,t", [(8, 48, 7, 3, 192), (4, 96, 11, 5, 128),
                                       (2, 192, 3, 5, 160)])
def test_conv1d_int8_one_window_matches_pallas(rng, p, c, k, d, t):
    x = (rng.standard_normal((1, c, t)) * 0.5).astype(np.float32)
    prm = _params(rng, c, k)
    res = (rng.standard_normal((1, c, t)) * 0.2).astype(np.float32)
    want = _unpacked(pallas_packed_conv1d(
        _packed(x, p), _hio(prm["w"]), jnp.asarray(prm["b"]),
        pad=d * (k - 1) // 2, dilation=d, p=p, residual=_packed(res, p),
        dot_dtype=jnp.int8, interpret=True), p)
    got = ops.conv1d_plain(_t(x), _t(prm["w"]), _t(prm["b"]), dilation=d,
                           residuals=(_t(res),), dot_dtype=torch.int8).numpy()
    assert _rel(got, want) <= 1e-4


# (p, C, K, d, T): one JAX tile and one port window (T <= 256 for D,
# <= 256 - 2 unit_halo(K) for E)
ONE_WINDOW = [(8, 48, 7, 3, 192), (2, 192, 3, 5, 160), (4, 96, 11, 1, 128)]


@pytest.mark.parametrize("p,c,k,d,t", ONE_WINDOW)
@pytest.mark.parametrize("dot_dtype", [torch.bfloat16, torch.int8])
def test_act_conv1d_plain_matches_pallas(rng, dot_dtype, p, c, k, d, t):
    x = (rng.standard_normal((1, c, t)) * 0.4).astype(np.float32)
    prm = _params(rng, c, k)
    res = (rng.standard_normal((1, c, t)) * 0.2).astype(np.float32)
    want = _unpacked(pallas_packed_act_conv1d(
        _packed(x, p), jnp.asarray(prm["alpha"]), jnp.asarray(prm["beta"]),
        True, _hio(prm["w"]), jnp.asarray(prm["b"]), pad=(k * d - d) // 2,
        dilation=d, p=p, residual=_packed(res, p), dot_dtype=JDT[dot_dtype],
        interpret=True), p)
    got = ops.act_conv1d_plain(
        _t(x), _t(prm["alpha"]), _t(prm["beta"]), True, _t(prm["w"]),
        _t(prm["b"]), dilation=d, residuals=(_t(res),),
        dot_dtype=dot_dtype).numpy()
    if dot_dtype == torch.bfloat16:
        _stat_close(got, want, 1e-4, 1e-2)
    else:
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("p,c,k,d,t", ONE_WINDOW)
@pytest.mark.parametrize("dot_dtype", [torch.bfloat16, torch.int8])
def test_amp_unit_plain_matches_pallas(rng, dot_dtype, p, c, k, d, t):
    x = (rng.standard_normal((1, c, t)) * 0.4).astype(np.float32)
    p1, p2 = _params(rng, c, k), _params(rng, c, k)
    res = (rng.standard_normal((1, c, t)) * 0.2).astype(np.float32)
    want = _unpacked(pallas_packed_amp_unit(
        _packed(x, p), jnp.asarray(p1["alpha"]), jnp.asarray(p1["beta"]),
        jnp.asarray(p2["alpha"]), jnp.asarray(p2["beta"]), True,
        _hio(p1["w"]), jnp.asarray(p1["b"]), _hio(p2["w"]),
        jnp.asarray(p2["b"]), pad1=(k * d - d) // 2, dil1=d,
        pad2=(k - 1) // 2, p=p, extra_residuals=_packed(res, p),
        out_scale=1.0 / 3, dot_dtype=JDT[dot_dtype], interpret=True), p)
    got = ops.amp_unit_plain(
        _t(x), _t(p1["alpha"]), _t(p1["beta"]), _t(p2["alpha"]),
        _t(p2["beta"]), True, _t(p1["w"]), _t(p1["b"]), _t(p2["w"]),
        _t(p2["b"]), dilation=d, extra_residuals=(_t(res),),
        out_scale=1.0 / 3, dot_dtype=dot_dtype).numpy()
    if dot_dtype == torch.bfloat16:
        _stat_close(got, want, 1e-4, 1e-2)
    else:
        assert _rel(got, want) <= 1e-4


# --- int8 over several windows: each side within the JAX tests' bounds ------------

def test_int8_multi_window_within_the_jax_bounds(rng):
    # tests/test_packed.py::TestInt8Dots shapes at 4x their length: several
    # tiles on both sides, windows that differ
    p, c, k, d, s = 8, 48, 7, 3, 96
    t = s * p
    x = (rng.standard_normal((1, c, t))).astype(np.float32)
    mk = lambda *sh: (rng.standard_normal(sh) * 0.1).astype(np.float32)  # noqa: E731
    w1, w2 = mk(c, c, k), mk(c, c, k)
    b1, b2 = mk(c) * 0.1, mk(c) * 0.1
    a1, be1, a2, be2 = mk(c), mk(c), mk(c), mk(c)
    pad1, pad2 = d * (k - 1) // 2, (k - 1) // 2

    conv = dict(pad=pad1, dilation=d, p=p, interpret=True)
    jax_conv = _unpacked(pallas_packed_conv1d(
        _packed(x, p), _hio(w1), jnp.asarray(b1), dot_dtype=jnp.int8,
        **conv), p)
    ref = ops.conv1d_plain(_t(x), _t(w1), _t(b1), dilation=d).numpy()
    port = ops.conv1d_plain(_t(x), _t(w1), _t(b1), dilation=d,
                            dot_dtype=torch.int8).numpy()
    assert _rel(jax_conv, ref) < 0.03 and _rel(port, ref) < 0.03
    assert _rel(port, jax_conv) > 1e-6  # the windows differ

    args = (_t(x), _t(a1), _t(be1), _t(a2), _t(be2), True, _t(w1), _t(b1),
            _t(w2), _t(b2))
    jax_unit = _unpacked(pallas_packed_amp_unit(
        _packed(x, p), jnp.asarray(a1), jnp.asarray(be1), jnp.asarray(a2),
        jnp.asarray(be2), True, _hio(w1), jnp.asarray(b1), _hio(w2),
        jnp.asarray(b2), pad1=pad1, dil1=d, pad2=pad2, p=p,
        dot_dtype=jnp.int8, interpret=True), p)
    ref = ops.amp_unit_plain(*args, dilation=d).numpy()
    port = ops.amp_unit_plain(*args, dilation=d, dot_dtype=torch.int8).numpy()
    assert _rel(jax_unit, ref) < 0.05 and _rel(port, ref) < 0.05
    jax_pair = _unpacked(pallas_packed_act_conv1d(
        _packed(x, p), jnp.asarray(a1), jnp.asarray(be1), True, _hio(w1),
        jnp.asarray(b1), dot_dtype=jnp.int8, **conv), p)
    ref = ops.act_conv1d_plain(*args[:3], True, _t(w1), _t(b1),
                               dilation=d).numpy()
    port = ops.act_conv1d_plain(*args[:3], True, _t(w1), _t(b1), dilation=d,
                                dot_dtype=torch.int8).numpy()
    assert _rel(jax_pair, ref) < 0.03 and _rel(port, ref) < 0.03


# --- the switch ------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [
    (None, None), (torch.bfloat16, torch.bfloat16), (torch.int8, torch.int8),
    ("bfloat16", torch.bfloat16), ("int8", torch.int8)])
def test_vocoder_conv_dtype_values(value, want):
    sr = FlowHighSR(vocoder_conv_dtype=value, device="cpu")
    assert sr.vocoder_conv_dtype == want
    assert sr.vocoder.conv_dtype == (want or torch.float32)
    assert sr.vocoder.boundary_dtype == (torch.float32 if want in (None, torch.int8)
                                         else torch.bfloat16)
    assert all(b.dot_dtype == (want or torch.float32)
               for b in sr.vocoder.resblocks)


@pytest.mark.parametrize("bad", [torch.float16, "fp8", jnp.int8, 8,
                                 torch.float32])
def test_vocoder_conv_dtype_refuses_others(bad):
    with pytest.raises(ValueError, match="vocoder_conv_dtype"):
        FlowHighSR(vocoder_conv_dtype=bad, device="cpu")


def test_vocoder_storage_dtype_is_not_ported():
    """``vocoder_storage_dtype`` is ported: the JAX package's values are
    accepted (by name for ``jnp.bfloat16``), any other is refused, and the
    bf16 maps reach every block of the vocoder."""
    for value, want in ((None, None), (torch.float32, None),
                        (torch.bfloat16, torch.bfloat16),
                        ("bfloat16", torch.bfloat16), (jnp.bfloat16,
                                                       torch.bfloat16),
                        (jnp.float32, None)):
        sr = FlowHighSR(vocoder_storage_dtype=value, device="cpu")
        assert sr.vocoder_storage_dtype == sr.vocoder.storage_dtype == want
    for bad in (torch.float16, torch.int8, "int8", jnp.int8, 16):
        with pytest.raises(ValueError, match="vocoder_storage_dtype"):
            FlowHighSR(vocoder_storage_dtype=bad, device="cpu")
    voc_cfg = pcfg.VocoderConfig(num_mels=8, upsample_initial_channel=32,
                                 upsample_rates=(4, 2),
                                 upsample_kernel_sizes=(8, 4),
                                 resblock_kernel_sizes=(3, 7),
                                 resblock_dilation_sizes=((1, 3), (1,)))
    voc = seeded_init_(BigVGAN(voc_cfg, storage_dtype=torch.bfloat16).eval(),
                       0)
    seen = {}
    for name, mod in voc.named_modules():
        if name.startswith("resblocks.") and name.count(".") == 1 \
                or name == "activation_post":
            mod.register_forward_hook(
                lambda m, i, o, n=name: seen.__setitem__(n, (i[0].dtype,
                                                             o.dtype)))
    with torch.no_grad():
        out = voc(torch.zeros(1, 6, 8))
    assert out.dtype == torch.float32 and out.shape == (1, 48)
    assert len(seen) == len(voc.resblocks) + 1
    assert set(seen.values()) == {(torch.bfloat16, torch.bfloat16)}


def test_cpu_tensors_take_the_plain_versions(rng):
    ops.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 16, 300)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 16, 3)).astype(np.float32))
    a = torch.zeros(16)
    for dt in (torch.bfloat16, torch.int8):
        torch.testing.assert_close(
            ops.conv1d(x, w, None, dot_dtype=dt),
            ops.conv1d_plain(x, w, None, dot_dtype=dt), rtol=0, atol=0)
        torch.testing.assert_close(
            ops.act_conv1d(x, a, None, True, w, None, dilation=1, dot_dtype=dt),
            ops.act_conv1d_plain(x, a, None, True, w, None, dilation=1,
                                 dot_dtype=dt), rtol=0, atol=0)
        torch.testing.assert_close(
            ops.amp_unit(x, a, None, a, None, True, w, None, w, None,
                         dilation=3, dot_dtype=dt),
            ops.amp_unit_plain(x, a, None, a, None, True, w, None, w, None,
                               dilation=3, dot_dtype=dt), rtol=0, atol=0)
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)
    assert all(fn.variant_launches[dt] == 0 for fn, dt in ops.VARIANTS)
