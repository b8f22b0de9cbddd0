"""The port's bf16 feature maps (``vocoder_storage_dtype``,
``BigVGAN(storage_dtype=)``) against the JAX package's
``storage_dtype=jnp.bfloat16`` on the CPU, where every kernel wrapper takes
its plain version. The kernels themselves need the card:
tests/test_torch_kernels.py holds them against these plain versions.

(a) Each plain version on bf16 maps is its f32 version on the widened maps,
rounded once to bf16 where the kernel stores: exact.
(b) Each plain version on bf16 maps against its JAX ``pallas_call`` in
interpret mode on the same bf16 input, under ``jax.jit``, at the dot
dtype's tolerance of tests/test_torch_dot_dtype.py (tests/test_torch_fused.py
and tests/test_torch_ops.py for float32 dots). Both round an f32 result to
bf16; where the two f32 results lie on either side of a rounding boundary
they come out one bf16 step apart, which is allowed on at most 1% of the
elements.
(c) The whole tiny vocoder, AMPBlock2's and ``generate`` against the JAX
package's fused vocoder with ``storage_dtype=jnp.bfloat16``. One flipped
bf16 rounding moves everything downstream of it
(tests/test_torch_dot_dtype_vocoder.py), so these are held statistically:
the port's distance from the JAX output within ``FLIP_SHARE`` of the
distance bf16 maps put between the port and its own f32-map output, and
that distance within the JAX package's own bound
(tests/test_packed.py::test_pallas_bigvgan_bf16_storage_close_to_f32: max
abs < 5e-2, correlation > 0.999).

A map rounds where a kernel stores it, so the rounding points follow the
routes: a unit that one package runs as kernel E keeps its middle map in
f32, the other's two act->conv pairs round it; two kernels A + B round the
activation that kernel D keeps on chip. The port routes by the card's plans
and the JAX package by the TPU's, which differ at some units of the
published config (ROADMAP.md queue 3), so (c) uses configs whose units both
route alike (checked), and ``test_rounding_points_follow_the_routes`` pins
the difference on one unit where they do not."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from flowhigh_tpu.ops.fused_act import fused_snake_activation1d
from flowhigh_tpu.ops.packed import (pack_time, packed_snake_activation1d,
                                     pallas_packed_act_conv1d,
                                     pallas_packed_amp_unit,
                                     pallas_packed_conv1d, unpack_time)
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat.jax_params import vocoder_state_from_jax
from flowhigh_tpu_torch.models import BigVGAN, bigvgan

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

BF = torch.bfloat16
DOTS = (torch.float32, torch.bfloat16, torch.int8)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int8: jnp.int8}
# the port's distance from the JAX output, as a share of bf16 maps' own
# distance from the f32-map output (tests/test_torch_dot_dtype_vocoder.py)
FLIP_SHARE = 0.75


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16(rng, *shape, scale=1.0):
    """Seeded values that bf16 holds exactly: (torch bf16, f32 numpy)."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(BF)
    return x, x.float().numpy()


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _btc(x):  # port [B, C, T] <-> JAX [B, T, C]
    return np.ascontiguousarray(np.swapaxes(np.asarray(x, np.float32), 1, 2))


def _jbf(x, p=1):  # f32 numpy [B, C, T] -> JAX bf16 [B, T/p, p C]
    return pack_time(jnp.asarray(_btc(x)), p).astype(jnp.bfloat16)


def _from_jax(y, p=1):  # JAX packed bf16 -> f32 numpy [B, C, T]
    assert y.dtype == jnp.bfloat16
    return _btc(np.asarray(unpack_time(y, p).astype(jnp.float32)))


def _hio(w):  # [Cout, Cin, K] -> [K, Cin, Cout]
    return jnp.asarray(w.transpose(2, 1, 0))


def _ulp(v):
    """The bf16 step at |v| (8 significant bits)."""
    a = np.abs(v)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0)))
                                   - 7), 0.0)


def _bf16_close(got, want, check, share=0.01):
    """bf16 outputs (as float arrays): elements one bf16 step apart (the
    two f32 results straddle a rounding boundary) on at most ``share`` of
    them; with those set to ``want``, ``check(got, want)`` is the dot
    dtype's f32 tolerance."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    one = (g != w) & (np.abs(g - w) <= np.maximum(_ulp(g), _ulp(w)))
    print(f"{int(one.sum())} of {g.size} elements one bf16 step apart")
    assert one.mean() <= share
    check(np.where(one, w, g), w)


def _atol(atol, rtol=0.0):
    return lambda g, w: np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def _stat(rel_l2, max_abs):  # tests/test_torch_dot_dtype.py::_stat_close
    def check(g, w):
        assert _rel(g, w) <= rel_l2 and np.abs(g - w).max() <= max_abs
    return check


def _rel_le(bound):
    return lambda g, w: _rel(g, w) <= bound or pytest.fail(
        f"rel {_rel(g, w):.3e} > {bound}")


# the f32 tolerance of each kernel at each dot dtype (tests/
# test_torch_dot_dtype.py for bf16 and int8; float32 dots: A and B
# tests/test_torch_ops.py and test_torch_conv_plan.py, D and E
# tests/test_torch_fused.py)
TOL = {("conv", torch.float32): _atol(2e-5, 1e-4),
       ("conv", torch.bfloat16): _atol(1e-5),
       ("conv", torch.int8): _rel_le(1e-4),
       ("pair", torch.float32): _atol(2e-4, 1e-4),
       ("pair", torch.bfloat16): _stat(1e-4, 1e-2),
       ("pair", torch.int8): _rel_le(1e-4),
       ("unit", torch.float32): _atol(3e-4, 2e-4),
       ("unit", torch.bfloat16): _stat(1e-4, 1e-2),
       ("unit", torch.int8): _rel_le(1e-4)}


def _act(rng, c):
    return _f32(rng, c, scale=0.2), _f32(rng, c, scale=0.2)


# --- (a) the plain versions on bf16 maps: the f32 function, rounded once -------

def _same(got, want_f32):
    assert got.dtype == BF
    assert torch.equal(got, want_f32.to(BF))


@pytest.mark.parametrize("b,c,t", [(2, 16, 131), (1, 8, 5)])
def test_snake_plain_on_bf16_maps_is_f32_rounded(rng, b, c, t):
    xb, _ = _bf16(rng, b, c, t)
    a, be = (_t(v) for v in _act(rng, c))
    _same(ops.snake_activation1d_plain(xb, a, be),
          ops.snake_activation1d_plain(xb.float(), a, be))
    _same(ops.snake_activation1d(xb, a, be),  # the CPU wrapper
          ops.snake_activation1d_plain(xb.float(), a, be))


@pytest.mark.parametrize("cin,cout,k,d,n_res", [(16, 24, 7, 3, 2),
                                                (48, 1, 7, 1, 0)])
@pytest.mark.parametrize("dot", DOTS)
def test_conv1d_plain_on_bf16_maps_is_f32_rounded(rng, dot, cin, cout, k, d,
                                                  n_res):
    t = 301
    xb, _ = _bf16(rng, 2, cin, t)
    w = _t(_f32(rng, cout, cin, k, scale=(cin * k) ** -0.5))
    bias = _t(_f32(rng, cout, scale=0.1))
    res = [_bf16(rng, 2, cout, t)[0] for _ in range(n_res)]
    kw = dict(dilation=d, out_scale=1 / 3, dot_dtype=dot)
    want = ops.conv1d_plain(xb.float(), w, bias,
                            residuals=[r.float() for r in res], **kw)
    _same(ops.conv1d_plain(xb, w, bias, residuals=res, **kw), want)
    _same(ops.conv1d(xb, w, bias, residuals=res, **kw), want)
    assert torch.equal(ops.conv.conv1d_amax_plain(xb, k, d),
                       ops.conv.conv1d_amax_plain(xb.float(), k, d))


@pytest.mark.parametrize("dot", DOTS)
def test_fused_plain_on_bf16_maps_is_f32_rounded(rng, dot):
    c, t, k, d = 48, 100, 7, 3
    xb, _ = _bf16(rng, 2, c, t, scale=0.4)
    a1, b1, a2, b2 = (_t(v) for v in _act(rng, c) + _act(rng, c))
    w1, w2 = (_t(_f32(rng, c, c, k, scale=0.05)) for _ in range(2))
    bias1, bias2 = (_t(_f32(rng, c, scale=0.1)) for _ in range(2))
    rb = _bf16(rng, 2, c, t, scale=0.2)[0]
    pair = dict(dilation=d, residuals=(rb,), out_scale=0.5, dot_dtype=dot)
    want = ops.act_conv1d_plain(xb.float(), a1, b1, True, w1, bias1,
                                **dict(pair, residuals=(rb.float(),)))
    _same(ops.act_conv1d_plain(xb, a1, b1, True, w1, bias1, **pair), want)
    _same(ops.act_conv1d(xb, a1, b1, True, w1, bias1, **pair), want)
    args = (a1, b1, a2, b2, True, w1, bias1, w2, bias2)
    unit = dict(dilation=d, extra_residuals=(rb,), out_scale=1 / 3,
                dot_dtype=dot)
    want = ops.amp_unit_plain(xb.float(), *args,
                              **dict(unit, extra_residuals=(rb.float(),)))
    _same(ops.amp_unit_plain(xb, *args, **unit), want)
    _same(ops.amp_unit(xb, *args, **unit), want)
    amax = dict(stride=256, lo=-9, width=274, n_win=1)
    assert torch.equal(
        ops.fused_conv.act_amax_plain(xb, a1, b1, True, **amax),
        ops.fused_conv.act_amax_plain(xb.float(), a1, b1, True, **amax))


def test_cpu_wrappers_on_bf16_maps_count_no_launches(rng):
    ops.reset_launch_counts()
    xb, _ = _bf16(rng, 1, 16, 40)
    w = _t(_f32(rng, 16, 16, 3, scale=0.1))
    a = torch.zeros(16)
    for dot in DOTS:
        assert ops.conv1d(xb, w, None, dot_dtype=dot).dtype == BF
        assert ops.act_conv1d(xb, a, None, True, w, None, dilation=1,
                              dot_dtype=dot).dtype == BF
        assert ops.amp_unit(xb, a, None, a, None, True, w, None, w, None,
                            dilation=3, dot_dtype=dot).dtype == BF
    assert ops.snake_activation1d(xb, a, None).dtype == BF
    assert all(fn.storage_launches[dt] == 0
               for fn, dt in ops.STORAGE_VARIANTS)
    assert len(ops.STORAGE_VARIANTS) == 12  # kernel C's two among them


# --- (b) the plain versions against the Pallas kernels on bf16 input ----------

@pytest.mark.parametrize("p,c,t", [(1, 16, 162), (4, 64, 256)])
def test_snake_plain_on_bf16_matches_pallas(rng, p, c, t):
    xb, x = _bf16(rng, 1, c, t)
    a, be = _act(rng, c)
    if p == 1:  # fused_snake_activation1d (the C = 768, 384 stages)
        fn = jax.jit(lambda v: fused_snake_activation1d(
            v, jnp.asarray(a), jnp.asarray(be), True, interpret=True))
    else:  # packed_snake_activation1d (packed stages, activation_post)
        fn = jax.jit(lambda v: packed_snake_activation1d(
            v, jnp.asarray(a), jnp.asarray(be), True, p, interpret=True))
    want = _from_jax(fn(_jbf(x, p)), p)
    got = ops.snake_activation1d_plain(xb, _t(a), _t(be)).float().numpy()
    _bf16_close(got, want, TOL["conv", torch.float32])


# (p, C, K, d, T): one JAX tile and one port window, as
# tests/test_torch_dot_dtype.py's ONE_WINDOW
P, C, K, D, T = 8, 48, 7, 3, 192


@pytest.mark.parametrize("dot", DOTS)
def test_conv1d_plain_on_bf16_matches_pallas(rng, dot):
    xb, x = _bf16(rng, 1, C, T, scale=0.5)
    w, bias = _f32(rng, C, C, K, scale=0.05), _f32(rng, C, scale=0.1)
    rb, r = _bf16(rng, 1, C, T, scale=0.2)
    wp, bp = _f32(rng, 1, C, 7, scale=C ** -0.5), _f32(rng, 1, scale=0.1)

    @jax.jit
    def run(v, res):
        y = pallas_packed_conv1d(v, _hio(w), jnp.asarray(bias),
                                 pad=D * (K - 1) // 2, dilation=D, p=P,
                                 residual=res, dot_dtype=JDT[dot],
                                 interpret=True)
        post = pallas_packed_conv1d(v, _hio(wp), jnp.asarray(bp), pad=3,
                                    dilation=1, p=P, dot_dtype=jnp.float32,
                                    interpret=True)  # conv_post's
        return y, post
    want, want_post = (_from_jax(v, P) for v in run(_jbf(x, P), _jbf(r, P)))
    got = ops.conv1d_plain(xb, _t(w), _t(bias), dilation=D, residuals=(rb,),
                           dot_dtype=dot)
    _bf16_close(got.float().numpy(), want, TOL["conv", dot])
    if dot == torch.float32:  # conv_post: kernel B's narrow route
        got = ops.conv1d_plain(xb, _t(wp), _t(bp))
        _bf16_close(got.float().numpy(), want_post, TOL["conv", dot])


@pytest.mark.parametrize("dot", DOTS)
def test_fused_plain_on_bf16_matches_pallas(rng, dot):
    xb, x = _bf16(rng, 1, C, T, scale=0.4)
    (a1, b1), (a2, b2) = _act(rng, C), _act(rng, C)
    w1, w2 = (_f32(rng, C, C, K, scale=0.05) for _ in range(2))
    bias1, bias2 = (_f32(rng, C, scale=0.1) for _ in range(2))
    rb, r = _bf16(rng, 1, C, T, scale=0.2)
    j = jnp.asarray

    @jax.jit
    def run(v, res):
        pair = pallas_packed_act_conv1d(
            v, j(a1), j(b1), True, _hio(w1), j(bias1), pad=D * (K - 1) // 2,
            dilation=D, p=P, residual=res, dot_dtype=JDT[dot],
            interpret=True)
        unit = pallas_packed_amp_unit(
            v, j(a1), j(b1), j(a2), j(b2), True, _hio(w1), j(bias1),
            _hio(w2), j(bias2), pad1=D * (K - 1) // 2, dil1=D,
            pad2=(K - 1) // 2, p=P, extra_residuals=res, out_scale=1.0 / 3,
            dot_dtype=JDT[dot], interpret=True)
        return pair, unit
    want_pair, want_unit = (_from_jax(v, P) for v in run(_jbf(x, P),
                                                         _jbf(r, P)))
    got = ops.act_conv1d_plain(xb, _t(a1), _t(b1), True, _t(w1), _t(bias1),
                               dilation=D, residuals=(rb,), dot_dtype=dot)
    _bf16_close(got.float().numpy(), want_pair, TOL["pair", dot])
    got = ops.amp_unit_plain(xb, _t(a1), _t(b1), _t(a2), _t(b2), True,
                             _t(w1), _t(bias1), _t(w2), _t(bias2), dilation=D,
                             extra_residuals=(rb,), out_scale=1.0 / 3,
                             dot_dtype=dot)
    _bf16_close(got.float().numpy(), want_unit, TOL["unit", dot])


# --- (c) the vocoder, AMPBlock2 and generate ----------------------------------

def _perturbed(params, seed):
    """Every 1-D leaf (snake parameters, biases) moved so that each shows."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    gen = np.random.default_rng(seed)
    leaves = [np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for v in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


# tests/test_torch_dot_dtype_vocoder.py's: C = 32 (packed p = 8 in the JAX
# package) and C = 16 (p = 16), k = 3 and k = 7 blocks
TINY_VOCODER = dict(num_mels=16, upsample_initial_channel=64,
                    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                    resblock_kernel_sizes=(3, 7),
                    resblock_dilation_sizes=((1, 3), (1, 3)))


def _routes(voc: dict, frames: int) -> list:
    """(JAX route, port route) of each AMPBlock1 unit of a vocoder config at
    ``frames`` mel frames: "E" (one kernel) or the two pairs' "D" / "AB"."""
    from flowhigh_tpu.ops import packed
    out, ch, t = [], voc["upsample_initial_channel"], frames
    for u in voc["upsample_rates"]:
        ch, t = ch // 2, t * u
        p = BigVGAN._pack_factor(ch, t)
        for k, ds in zip(voc["resblock_kernel_sizes"],
                         voc["resblock_dilation_sizes"]):
            for d in ds:
                j = "E" if packed.amp_unit_plan(k, d, p, ch) else "/".join(
                    "D" if packed.act_conv_plan(k, (k * dd - dd) // 2, dd, p,
                                                ch) else "AB"
                    for dd in (d, 1))
                q = "E" if ops.amp_unit_plan(k, d, ch, t) else "/".join(
                    "D" if ops.act_conv_plan(k, dd, ch, t) else "AB"
                    for dd in (d, 1))
                out.append((j, q))
    return out


def _vocoder_case(rng, voc_cfg, dot, frames):
    """(port output with bf16 maps, with f32 maps, JAX output with bf16
    maps) of one seeded tiny vocoder, whose units both packages route
    alike."""
    kw = voc_cfg
    assert all(j == q for j, q in _routes(kw, frames))
    cfg = jcfg.VocoderConfig(**kw)
    params = _perturbed(jax.device_get(_fast_init(
        lambda r: JaxBigVGAN(cfg).init(r, jnp.zeros((1, 8, 16))),
        jax.random.PRNGKey(3))), 4)
    state = vocoder_state_from_jax(params, pcfg.VocoderConfig(**kw))
    jvoc = JaxBigVGAN(cfg, fused_act=True, packed=True, pallas_convs=True,
                      fuse_act_conv=True,
                      conv_dtype=None if dot == torch.float32 else JDT[dot],
                      storage_dtype=jnp.bfloat16)
    mel = (rng.standard_normal((1, frames, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jvoc.apply)(params, jnp.asarray(mel)))
    outs = []
    for store in (BF, None):
        voc = BigVGAN(pcfg.VocoderConfig(**kw), conv_dtype=dot,
                      storage_dtype=store).eval()
        voc.load_state_dict(state)
        with torch.no_grad():
            outs.append(voc(torch.from_numpy(mel)).numpy())
    return outs[0], outs[1], want


def _held(got, f32, want, what):
    own = _rel(got, f32)
    print(f"{what}: port vs JAX rel L2 {_rel(got, want):.3e}, max abs "
          f"{np.abs(got - want).max():.3e}; bf16 maps vs f32 maps {own:.3e}")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.dtype == np.float32
    assert own > 1e-4  # the maps really were rounded
    assert _rel(got, want) <= FLIP_SHARE * own
    # the JAX package's own bound of bf16 maps against f32
    assert np.abs(got - f32).max() < 5e-2
    assert np.corrcoef(got.ravel(), f32.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("dot,frames", [(torch.float32, 40),
                                        (torch.bfloat16, 40),
                                        (torch.int8, 8)])
def test_vocoder_matches_jax_bf16_storage(rng, dot, frames):
    _held(*_vocoder_case(rng, TINY_VOCODER, dot, frames), f"AMPBlock1 {dot}")


# AMPBlock2 on the tiny vocoder's stages, one resblock each
TINY_RESBLOCK2 = dict(TINY_VOCODER, resblock="2", resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3),))


@pytest.mark.parametrize("dot", [torch.float32, torch.bfloat16])
def test_resblock2_vocoder_matches_jax_bf16_storage(rng, dot):
    # the JAX package refuses int8 dots in AMPBlock2's packed convs
    got, f32, want = _vocoder_case(rng, TINY_RESBLOCK2, dot, 24)
    _held(got, f32, want, f"AMPBlock2 {dot}")
    if dot == torch.bfloat16:  # both sides round at the same places
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("ch,t", [(48, 480), (192, 80), (96, 90), (256, 8),
                                  (16, 24), (1536, 5), (8, 32), (8, 33)])
def test_pack_factor_is_the_jax_rule(ch, t):
    jvoc = JaxBigVGAN(jcfg.VocoderConfig(), packed=True)
    assert BigVGAN._pack_factor(ch, t) == jvoc._pack_factor(ch, t)


def _conv_post_input(cfg, frames):
    """The dtypes of conv_post's input and output in a bf16-map forward."""
    voc = BigVGAN(cfg, storage_dtype=BF).eval()
    seen, saved = [], bigvgan.conv1d

    def spy(x, w, *a, **kw):
        y = saved(x, w, *a, **kw)
        if w.shape[0] == 1:  # conv_post: Cout = 1
            seen.append((x.dtype, y.dtype))
        return y
    bigvgan.conv1d = spy
    try:
        with torch.no_grad():
            out = voc(torch.zeros(1, frames, cfg.num_mels))
    finally:
        bigvgan.conv1d = saved
    assert out.dtype == torch.float32
    return seen


def test_conv_post_rounds_where_the_jax_package_runs_pallas():
    # the last stage packs (C = 16, p = 16): Pallas conv_post, bf16 out
    packs = pcfg.VocoderConfig(**TINY_VOCODER)
    assert _conv_post_input(packs, 4) == [(BF, BF)]
    # 256 channels at the last stage: p = 1, XLA's conv on f32
    wide = pcfg.VocoderConfig(num_mels=16, upsample_initial_channel=512,
                              upsample_rates=(2,), upsample_kernel_sizes=(4,),
                              resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1,),))
    assert _conv_post_input(wide, 4) == [(torch.float32, torch.float32)]


def test_rounding_points_follow_the_routes(rng):
    # tests/test_torch_dot_dtype_vocoder.py's small generate config has one
    # unit the two packages route apart: C = 32, K = 11, d = 5 at its first
    # stage, two pairs (D/D) in the JAX package, one unit (E) on the card.
    # The JAX package then stores the middle map in bf16, the port keeps it
    # f32: JAX's unit equals the port's two pairs on bf16 maps (within
    # flips), and differs from the port's unit by that one rounding
    routes = _routes(SMALL_VOCODER, 50)
    assert routes[1] == ("D/D", "E") and routes.count(("D/D", "E")) == 1
    c, t, k, d, p = 32, 400, 11, 5, 8
    xb, x = _bf16(rng, 1, c, t, scale=0.4)
    (a1, b1), (a2, b2) = _act(rng, c), _act(rng, c)
    w1, w2 = (_f32(rng, c, c, k, scale=0.05) for _ in range(2))
    bias1, bias2 = (_f32(rng, c, scale=0.1) for _ in range(2))
    j = jnp.asarray

    @jax.jit
    def pairs(v):  # the JAX package's AMPBlock1._act_then_conv, twice
        h = pallas_packed_act_conv1d(v, j(a1), j(b1), True, _hio(w1), j(bias1),
                                     pad=d * (k - 1) // 2, dilation=d, p=p,
                                     interpret=True)
        return pallas_packed_act_conv1d(h, j(a2), j(b2), True, _hio(w2),
                                        j(bias2), pad=(k - 1) // 2,
                                        dilation=1, p=p, residual=v,
                                        interpret=True)
    want = _from_jax(pairs(_jbf(x, p)), p)
    h = ops.act_conv1d_plain(xb, _t(a1), _t(b1), True, _t(w1), _t(bias1),
                             dilation=d)
    assert h.dtype == BF  # the middle map, stored by a pair
    got_pairs = ops.act_conv1d_plain(h, _t(a2), _t(b2), True, _t(w2),
                                     _t(bias2), dilation=1, residuals=(xb,))
    _bf16_close(got_pairs.float().numpy(), want, TOL["pair", torch.float32])
    got_unit = ops.amp_unit_plain(xb, _t(a1), _t(b1), _t(a2), _t(b2), True,
                                  _t(w1), _t(bias1), _t(w2), _t(bias2),
                                  dilation=d).float().numpy()
    moved = _rel(got_unit, want)
    print(f"the port's unit against the JAX pairs: rel L2 {moved:.3e}")
    assert 1e-4 < moved < 2 ** -8  # one bf16 rounding of the middle map


SMALL_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
SMALL_VOCODER = dict(num_mels=256, upsample_initial_channel=64,
                     upsample_rates=(8, 5, 4, 3),
                     upsample_kernel_sizes=(16, 11, 8, 7),
                     resblock_kernel_sizes=(3, 11),
                     resblock_dilation_sizes=((1,), (5,)))
# the generate test's: two stages (the hop, 480 samples, in two
# upsamplers) of one k = 3 unit each, which both packages route to one
# kernel (E)
GEN_VOCODER = dict(SMALL_VOCODER, upsample_rates=(24, 20),
                   upsample_kernel_sizes=(48, 40), resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1,),))


@pytest.mark.parametrize("dot", ["float32", "bfloat16", "int8"])
def test_generate_matches_jax_bf16_storage(rng, dot):
    # the small model of tests/test_torch_dot_dtype_vocoder.py, a two-stage
    # vocoder, on a 0.5 s clip (50 mel frames)
    assert all(j == q for j, q in _routes(GEN_VOCODER, 50))
    cj = jcfg.FlowHighConfig().replace(
        model=jcfg.ModelConfig(**SMALL_MODEL),
        vocoder=jcfg.VocoderConfig(**GEN_VOCODER))
    cp = pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**SMALL_MODEL),
        vocoder=pcfg.VocoderConfig(**GEN_VOCODER))
    conv = None if dot == "float32" else dot
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler", fused_vocoder=True,
                        vocoder_conv_dtype=conv and getattr(jnp, conv),
                        vocoder_storage_dtype=jnp.bfloat16)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    mel = jnp.zeros((1, 16, 256))
    jsr.params = jsr.net.init(r1, mel, times=jnp.zeros(()), cond=mel)
    jsr.melvoco.vocoder_params = _perturbed(jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2)), 2)
    kw = dict(cfm_method="independent_cfm_adaptive", ode_method="euler",
              vocoder_conv_dtype=conv, device="cpu")
    weights = (jax.device_get(jsr.params), jsr.melvoco.vocoder_params)
    psr = FlowHighSR(cp, *weights, vocoder_storage_dtype=jnp.bfloat16, **kw)
    f32 = FlowHighSR(cp, *weights, **kw)
    assert psr.vocoder.storage_dtype == BF
    audio = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    want = jsr.generate(audio, 16000, timestep=1)
    got = psr.generate(audio, 16000, timestep=1)
    ref = f32.generate(audio, 16000, timestep=1)
    assert want.shape == (1, 24000)
    if dot != "int8":
        _held(got, ref, want, f"generate {dot}")
        return
    # int8 over several windows: the two packages quantise over other
    # windows (ops/quant.py), two quantisations of one function, each held
    # to the JAX package's bound of its f32 output, as
    # tests/test_torch_dot_dtype_vocoder.py holds int8 generate
    print(f"generate int8: port vs JAX rel L2 {_rel(got, want):.3e}; bf16 "
          f"maps vs f32 maps {_rel(got, ref):.3e}")
    assert np.isfinite(got).all() and _rel(got, want) < 0.1
    assert _rel(got, ref) < 0.1
