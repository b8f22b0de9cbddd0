"""The port's fused vocoder kernels (D: act->conv pair, E: AMPBlock1 unit)
against the JAX package's Pallas kernels, run in interpret mode on the CPU:
each plain version computes what its Pallas counterpart computes. Then the
card's fusion plans at full width, the fused vocoder against the unfused
one, and the port's default (fused) ``generate`` against the JAX package's
fused vocoder path. The kernels themselves need the card:
tests/test_torch_kernels.py holds them against these plain versions.

Layouts: the JAX kernels take space-to-depth packed [B, T/p, p*C] rows and
[K, Cin, Cout] weights; the port takes [B, C, T] and PyTorch's [Cout, Cin,
K]. Tests pack and transpose at the comparison, never inside the code under
test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.ops.packed import (pack_time, pallas_packed_act_conv1d,
                                     pallas_packed_amp_unit, unpack_time)
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat import seeded_init_
from flowhigh_tpu_torch.models import BigVGAN
from flowhigh_tpu_torch.ops import fused_conv


def _btc(x):  # port [B, C, T] -> JAX [B, T, C]
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


def _packed(x, p):  # port [B, C, T] -> JAX packed [B, T/p, p*C]
    return pack_time(jnp.asarray(_btc(x)), p)


def _unpacked(y, p):  # JAX packed -> [B, T, C]
    return np.asarray(unpack_time(y, p))


def _params(rng, c, k, scale_w=0.05):
    f32 = np.float32
    return dict(alpha=(rng.standard_normal(c) * 0.2).astype(f32),
                beta=(rng.standard_normal(c) * 0.2).astype(f32),
                w=(rng.standard_normal((c, c, k)) * scale_w).astype(f32),
                b=(rng.standard_normal(c) * 0.1).astype(f32))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _hio(w):  # [Cout, Cin, K] -> [K, Cin, Cout]
    return jnp.asarray(w.transpose(2, 1, 0))


# --- kernel D: the act->conv pair ---------------------------------------------

# tests/test_packed.py::TestFusedActConv::test_matches_unfused shapes
PAIRS = [(8, 48, 3, 1), (8, 48, 11, 5), (4, 96, 7, 3), (2, 192, 3, 1),
         (1, 384, 7, 3), (1, 384, 3, 1), (2, 192, 11, 3), (2, 192, 11, 5),
         (1, 384, 11, 1)]


@pytest.mark.parametrize("p,c,k,d", PAIRS)
def test_act_conv_plain_matches_pallas(rng, p, c, k, d):
    s = 96
    x = (rng.standard_normal((2, c, s * p)) * 0.4).astype(np.float32)
    prm = _params(rng, c, k)
    res = (rng.standard_normal((2, c, s * p)) * 0.2).astype(np.float32)
    want = _unpacked(pallas_packed_act_conv1d(
        _packed(x, p), jnp.asarray(prm["alpha"]), jnp.asarray(prm["beta"]),
        True, _hio(prm["w"]), jnp.asarray(prm["b"]), pad=(k * d - d) // 2,
        dilation=d, p=p, residual=_packed(res, p), interpret=True), p)
    got = ops.act_conv1d_plain(
        _t(x), _t(prm["alpha"]), _t(prm["beta"]), True, _t(prm["w"]),
        _t(prm["b"]), dilation=d, residuals=(_t(res),)).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=2e-4, rtol=1e-4)


def test_act_conv_plain_awkward_rows_no_residual(rng):
    # tests/test_packed.py::test_awkward_rows_and_no_residual: 37 packed rows
    p, c, k = 8, 48, 7
    x = (rng.standard_normal((1, c, 37 * p)) * 0.4).astype(np.float32)
    prm = _params(rng, c, k)
    want = _unpacked(pallas_packed_act_conv1d(
        _packed(x, p), jnp.asarray(prm["alpha"]), jnp.asarray(prm["beta"]),
        True, _hio(prm["w"]), None, pad=3, dilation=1, p=p, interpret=True), p)
    got = ops.act_conv1d_plain(_t(x), _t(prm["alpha"]), _t(prm["beta"]), True,
                               _t(prm["w"]), None, dilation=1).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=2e-4, rtol=1e-4)


# --- kernel E: the AMPBlock1 unit ---------------------------------------------

# tests/test_packed.py::TestFusedActConv::test_amp_unit_matches_pairs shapes,
# T = 37 (short input) and 250 packed rows (indivisible) included
UNITS = [(8, 48, 11, 5, 256), (8, 48, 3, 1, 256), (4, 96, 7, 3, 256),
         (2, 192, 7, 3, 256), (1, 384, 3, 1, 512), (8, 48, 7, 3, 96),
         (8, 48, 3, 1, 250), (8, 48, 11, 5, 37)]


@pytest.mark.parametrize("p,c,k,d,s", UNITS)
def test_amp_unit_plain_matches_pallas(rng, p, c, k, d, s):
    x = (rng.standard_normal((1, c, s * p)) * 0.4).astype(np.float32)
    p1, p2 = _params(rng, c, k), _params(rng, c, k)
    res = (rng.standard_normal((1, c, s * p)) * 0.2).astype(np.float32)
    want = _unpacked(pallas_packed_amp_unit(
        _packed(x, p), jnp.asarray(p1["alpha"]), jnp.asarray(p1["beta"]),
        jnp.asarray(p2["alpha"]), jnp.asarray(p2["beta"]), True,
        _hio(p1["w"]), jnp.asarray(p1["b"]), _hio(p2["w"]),
        jnp.asarray(p2["b"]), pad1=(k * d - d) // 2, dil1=d,
        pad2=(k - 1) // 2, p=p, extra_residuals=_packed(res, p),
        out_scale=1.0 / 3, interpret=True), p)
    got = ops.amp_unit_plain(
        _t(x), _t(p1["alpha"]), _t(p1["beta"]), _t(p2["alpha"]),
        _t(p2["beta"]), True, _t(p1["w"]), _t(p1["b"]), _t(p2["w"]),
        _t(p2["b"]), dilation=d, extra_residuals=(_t(res),),
        out_scale=1.0 / 3).numpy()
    np.testing.assert_allclose(_btc(got), want, atol=3e-4, rtol=2e-4)


def test_amp_unit_plain_is_two_pairs(rng):
    c, t, k, d = 16, 50, 11, 3
    x = torch.from_numpy(rng.standard_normal((2, c, t)).astype(np.float32))
    p1, p2 = _params(rng, c, k), _params(rng, c, k)
    e = torch.from_numpy(rng.standard_normal((2, c, t)).astype(np.float32))
    h = ops.act_conv1d_plain(x, _t(p1["alpha"]), None, False, _t(p1["w"]),
                             None, dilation=d)
    want = ops.act_conv1d_plain(h, _t(p2["alpha"]), None, False, _t(p2["w"]),
                                _t(p2["b"]), dilation=1, residuals=(x, e),
                                out_scale=0.5)
    got = ops.amp_unit_plain(x, _t(p1["alpha"]), None, _t(p2["alpha"]), None,
                             False, _t(p1["w"]), None, _t(p2["w"]),
                             _t(p2["b"]), dilation=d, extra_residuals=(e,),
                             out_scale=0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- the card's plans ------------------------------------------------------------

FULL_WIDTH = [(768, 5000), (384, 20000), (192, 80000), (96, 240000),
              (48, 480000)]  # (C, T) per stage of a 10 s clip


@pytest.mark.parametrize("c,t", FULL_WIDTH)
def test_plans_at_full_width(c, t):
    for k in (3, 7, 11):
        h = (k - 1) // 2 + 6
        for d in (1, 3, 5):
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                int8 = dt == torch.int8
                # D: 64-sample tiles on the tensor cores where 256 divides
                # C (256-channel blocks), 128 elsewhere, at every dtype
                # (int8's tile the 256-sample windows)
                assert ops.act_conv_plan(k, d, c, t, dt) == (
                    64 if c % 256 == 0 else 128)
                assert fused_conv.act_conv_smem_bytes(k, d, c, dt) <= 232448
                tile = ops.amp_unit_plan(k, d, c, t, dt)
                fits = fused_conv.amp_unit_smem_bytes(k, d, c, dt) <= 232448
                # conv1's output for all C channels over a pass fits up to
                # C = 192 (on the tensor cores a 192-sample pass there;
                # at C = 96 and 48 128 for bf16, 256 for f32 and int8); at
                # 384 and 768 the unit runs as two kernel-D pairs
                assert fits == (c <= 192)
                bn = 192 if c == 192 and not int8 else \
                    128 if dt == torch.bfloat16 else 256
                assert tile == (bn - 2 * h if fits else 0)


def test_plans_refuse_what_no_kernel_takes():
    assert ops.act_conv_plan(5, 1, 64, 100) == 0      # no K = 5 instance
    assert ops.amp_unit_plan(5, 1, 64, 100) == 0
    assert ops.act_conv_plan(3, 1000, 64, 100) == 0   # window outgrows 227 KB
    assert ops.amp_unit_plan(3, 1, 256, 100) == 0     # conv1 buffer too wide
    # int8 in a cluster of three 96-channel blocks: C = 200 fits every dtype
    assert ops.amp_unit_plan(3, 1, 200, 100, torch.int8) == 242
    assert ops.amp_unit_plan(3, 1, 160, 5) == 178     # any T, any C <= 192
    assert ops.amp_unit_plan(3, 1, 160, 5, torch.int8) == 242


def test_cpu_tensors_take_the_plain_versions(rng):
    ops.reset_launch_counts()
    c, t, k = 8, 40, 3
    x = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    prm = {n: _t(v) for n, v in _params(rng, c, k).items()}
    args = (x, prm["alpha"], prm["beta"], True, prm["w"], prm["b"])
    torch.testing.assert_close(
        ops.act_conv1d(*args, dilation=3, residuals=(x,)),
        ops.act_conv1d_plain(*args, dilation=3, residuals=(x,)), rtol=0, atol=0)
    uargs = (x, prm["alpha"], prm["beta"], prm["alpha"], None, True, prm["w"],
             prm["b"], prm["w"], None)
    torch.testing.assert_close(ops.amp_unit(*uargs, dilation=5),
                               ops.amp_unit_plain(*uargs, dilation=5),
                               rtol=0, atol=0)
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)


# --- the vocoder -------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [True, "pairs", "auto"])
def test_fused_vocoder_equals_unfused_on_cpu(rng, fuse):
    cfg = pcfg.VocoderConfig(num_mels=32, upsample_initial_channel=64,
                             upsample_rates=(4, 2),
                             upsample_kernel_sizes=(8, 4))
    ref = seeded_init_(BigVGAN(cfg, fuse_act_conv=False).eval(), 0)
    with torch.no_grad():  # non-trivial snake parameters
        for name, prm in ref.named_parameters():
            if name.endswith((".alpha", ".beta")):
                prm.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
    voc = BigVGAN(cfg, fuse_act_conv=fuse).eval()
    voc.load_state_dict(ref.state_dict())
    mel = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    with torch.no_grad():
        want, got = ref(mel), voc(mel)
    # on the CPU every kernel wrapper is its plain composition: exact
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fuse_act_conv_values():
    cfg = pcfg.VocoderConfig(upsample_initial_channel=32)
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="fuse_act_conv"):
            BigVGAN(cfg, fuse_act_conv=bad)


# --- generate against the JAX package's fused vocoder -------------------------

# one stage at C = 32 (packed p = 8 in the JAX package), where the JAX plans
# fuse the k = 3 unit (amp_unit_plan) and split the k = 11, d = 5 unit into
# two fused pairs (act_conv_plan); the later stages fuse whole units. The
# upsamplers keep (K - stride) even, as the JAX package's packed path needs.
SMALL_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
SMALL_VOCODER = dict(num_mels=256, upsample_initial_channel=64,
                     upsample_rates=(8, 5, 4, 3),
                     upsample_kernel_sizes=(16, 11, 8, 7),
                     resblock_kernel_sizes=(3, 11),
                     resblock_dilation_sizes=((1,), (5,)))


def test_jax_plans_route_units_and_pairs_in_the_small_config():
    from flowhigh_tpu.ops.packed import act_conv_plan, amp_unit_plan
    assert amp_unit_plan(3, 1, 8, 32) > 0                  # unit
    assert amp_unit_plan(11, 5, 8, 32) == 0                # ...not fused
    assert act_conv_plan(11, 25, 5, 8, 32) > 0             # so two pairs


def test_generate_matches_jax_fused_vocoder(rng):
    cj = jcfg.FlowHighConfig().replace(
        model=jcfg.ModelConfig(**SMALL_MODEL),
        vocoder=jcfg.VocoderConfig(**SMALL_VOCODER))
    cp = pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**SMALL_MODEL),
        vocoder=pcfg.VocoderConfig(**SMALL_VOCODER))
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler", fused_vocoder=True)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    mel = jnp.zeros((1, 16, 256))
    jsr.params = jsr.net.init(r1, mel, times=jnp.zeros(()), cond=mel)
    # the vocoder has no norms: kernels from fan-in normals (shape-only
    # init, no compile of the Pallas forward), every 1-D leaf (snake
    # log-alpha/beta, biases) perturbed so that each shows
    voc = jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2))
    leaves, tree = jax.tree_util.tree_flatten(voc)
    gen = np.random.default_rng(2)
    leaves = [np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for v in leaves]
    jsr.melvoco.vocoder_params = jax.tree_util.tree_unflatten(tree, leaves)
    psr = FlowHighSR(cp, jax.device_get(jsr.params), jsr.melvoco.vocoder_params,
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    assert psr.vocoder.resblocks[0].fuse_act_conv is True
    audio = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    want = jsr.generate(audio, 16000, timestep=1)
    got = psr.generate(audio, 16000, timestep=1)
    assert got.shape == want.shape == (1, 48000)
    # log-mel (f64 FFT vs f32 DFT), vector field and vocoder in other
    # summation orders
    np.testing.assert_allclose(got, want, atol=1e-3)
