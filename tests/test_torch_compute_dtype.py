"""The vocoder's compute dtype (``BigVGAN(dtype=)``, ``MelVoco(dtype=)``)
against the JAX package's fused vocoder at ``dtype=jnp.bfloat16`` on the
CPU, where every kernel wrapper takes its plain version. Kernel C on bf16
maps needs the card: tests/test_torch_kernels.py holds it against the plain
version here.

(a) Kernel C's plain version on bf16 maps is its float32 version on the
widened map, rounded once to bf16: exact.
(b) C's plain version on bf16 maps against the JAX
``pallas_packed_conv_transpose1d`` in interpret mode on the same bf16 input
and bf16-valued weights, at float32 and bf16 dots, under ``jax.jit``: both
round an f32 result once, so they may come out one bf16 step apart where
the two f32 sums straddle a rounding boundary, on at most 1% of the
outputs; the rest holds at the dot dtype's tolerance of
tests/test_torch_ops.py (float32) and tests/test_torch_dot_dtype.py (bf16).
(c) The tiny vocoders of tests/test_torch_storage.py at ``dtype=bf16``
against the JAX package's fused vocoder (``fused_act``, ``packed``,
``pallas_convs``, ``fuse_act_conv`` all True: the dtype flow the port
follows) at ``dtype=jnp.bfloat16``, compiled without XLA's excess
precision (tests/test_torch_vector_options.py). One flipped bf16 rounding
moves everything after it, so they are held as tests/test_torch_storage.py
holds bf16 maps (``_held``): the port's distance from JAX within
``FLIP_SHARE`` of its own distance from its float32 output, and that
distance above 1e-4 and within chip_smoke.py's phase P bound of the dot
dtype (``FROM_F32``). No JAX test runs a bf16-compute vocoder, so there is
no JAX bound of the distance to copy. AMPBlock2 runs on both kinds of
stage: packed (bf16 maps) and not packed (XLA's bf16 conv, then the f32
bias).
(d) ``MelVoco(dtype=)`` and ``BigVGAN(dtype=)`` take the names and the JAX
package's ``jnp.bfloat16`` and refuse float16.
(e) Under autograd the bf16-compute vocoder raises the JAX package's
error, as ``jax.grad`` does on the fused vocoder's Pallas kernels.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import config as jcfg
from flowhigh_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from flowhigh_tpu.ops.packed import pallas_packed_conv_transpose1d
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.compat.jax_params import vocoder_state_from_jax
from flowhigh_tpu_torch.models import BigVGAN, MelVoco, bigvgan
from flowhigh_tpu_torch.ops.conv import PALLAS_NO_GRAD, conv_weights
from flowhigh_tpu_torch.ops.quant import compute_weights, round_bf16
from test_torch_storage import (FLIP_SHARE, TINY_RESBLOCK2, TINY_VOCODER, TOL,
                                _bf16, _bf16_close, _f32, _from_jax, _jbf,
                                _perturbed, _rel, _routes, _t)

BF = torch.bfloat16
JDT = {torch.float32: None, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}
UPSAMPLERS = [(5, 11), (4, 8), (3, 7), (2, 4)]  # BigVGAN's (u, K) pairs
# the fused vocoder's lowering switches, and MelVoco's defaults (unfused)
FUSED = dict(fused_act=True, packed=True, pallas_convs=True,
             fuse_act_conv=True)


def _bf16_values(rng, *shape, scale=1.0):
    """float32 numpy values that bf16 holds exactly (weights as the model
    hands them to a kernel at bf16 compute)."""
    return round_bf16(torch.from_numpy(_f32(rng, *shape, scale=scale))).numpy()


# --- (a) kernel C's plain version on bf16 maps ------------------------------------

@pytest.mark.parametrize("u,k", UPSAMPLERS)
@pytest.mark.parametrize("dot", [torch.float32, torch.bfloat16])
def test_conv_transpose1d_plain_on_bf16_maps_is_f32_rounded(rng, dot, u, k):
    xb, _ = _bf16(rng, 2, 24, 37)  # odd T
    w = _t(_f32(rng, 24, 16, k, scale=(16 * k) ** -0.5))
    bias = _t(_f32(rng, 16, scale=0.1))
    want = ops.conv_transpose1d_plain(xb.float(), w, bias, stride=u,
                                      dot_dtype=dot).to(BF)
    for fn in (ops.conv_transpose1d_plain, ops.conv_transpose1d):
        got = fn(xb, w, bias, stride=u, dot_dtype=dot)
        assert got.dtype == BF and got.shape == (2, 16, u * 37)
        assert torch.equal(got, want)


def test_cpu_wrapper_on_bf16_maps_counts_no_launches(rng):
    ops.reset_launch_counts()
    xb, _ = _bf16(rng, 1, 16, 40)
    w = _t(_f32(rng, 16, 8, 8, scale=0.1))
    for dot in (torch.float32, torch.bfloat16):
        assert ops.conv_transpose1d(xb, w, None, stride=4,
                                    dot_dtype=dot).dtype == BF
    assert ops.conv_transpose1d.storage_launches == {torch.float32: 0, BF: 0}
    assert (ops.conv_transpose1d, torch.float32) in ops.STORAGE_VARIANTS
    assert (ops.conv_transpose1d, BF) in ops.STORAGE_VARIANTS


# --- (b) against the Pallas kernel on bf16 input ----------------------------------

@pytest.fixture(scope="module")
def convt_cases():
    """Each upsampler pair's bf16 input, bf16-valued weights and f32 bias,
    and the JAX kernel's outputs at f32 and bf16 dots: one jitted
    function for all."""
    rng = np.random.default_rng(5)
    cin, cout, t = 16, 8, 41
    cases = [(_bf16(rng, 1, cin, t),
              _bf16_values(rng, cin, cout, k, scale=(cout * k) ** -0.5),
              _f32(rng, cout, scale=0.1)) for _, k in UPSAMPLERS]

    @jax.jit
    def run(xs):  # the fused vocoder's call: bf16 x and weights, f32 bias
        return [[pallas_packed_conv_transpose1d(
            v, jnp.asarray(w.transpose(2, 1, 0)).astype(jnp.bfloat16),
            jnp.asarray(b), stride=u, padding=(k - u) // 2, p_in=1, p_out=1,
            dot_dtype=dt, interpret=True)
            for dt in (jnp.float32, jnp.bfloat16)]
            for v, (u, k), (_, w, b) in zip(xs, UPSAMPLERS, cases)]
    outs = run([_jbf(x) for (_, x), _, _ in cases])
    return {pair: (case, [_from_jax(y) for y in out])
            for pair, case, out in zip(UPSAMPLERS, cases, outs)}


@pytest.mark.parametrize("u,k", UPSAMPLERS)
def test_conv_transpose1d_plain_on_bf16_matches_pallas(convt_cases, u, k):
    ((xb, _), w, bias), wants = convt_cases[u, k]
    for dot, want in zip((torch.float32, BF), wants):
        got = ops.conv_transpose1d_plain(xb, _t(w), _t(bias), stride=u,
                                         dot_dtype=dot)
        assert got.dtype == BF
        _bf16_close(got.float().numpy(), want,
                    TOL["conv", torch.float32] if dot == torch.float32
                    else TOL["conv", BF])


# --- the rounded weights --------------------------------------------------------------

def test_rounded_weights_have_their_own_layouts():
    w = torch.nn.Parameter(torch.randn(16, 16, 3))
    assert compute_weights(w, torch.float32) is w
    with torch.inference_mode():  # MelVoco.decode's mode
        wr = compute_weights(w, BF)
        layout = conv_weights(wr, torch.float32)
        assert compute_weights(w, BF) is wr
        assert conv_weights(compute_weights(w, BF), torch.float32) is layout
        own = conv_weights(w, torch.float32)
    assert torch.equal(wr, round_bf16(w.detach())) and not torch.equal(wr, w)
    assert own is not layout and not torch.equal(own, layout)
    with torch.no_grad():
        w.add_(1.0)  # a new version: a new rounding
    assert torch.equal(compute_weights(w, BF), round_bf16(w.detach()))


# --- (c) the vocoder against the JAX package's fused vocoder at bf16 ---------------

# chip_smoke.FROM_F32: rel L2 from the float32 output, by dot dtype
FROM_F32 = {torch.float32: 0.1, torch.bfloat16: 0.1, torch.int8: 0.25}
# the tiny vocoder with one dilation a resblock: half the units, half the
# JAX compile (~12 s a dot dtype on one core)
TINY_SHORT = dict(TINY_VOCODER, resblock_dilation_sizes=((1,), (3,)))


def _held(got, f32, want, what, dot):
    own = _rel(got, f32)
    print(f"{what}: port vs JAX rel L2 {_rel(got, want):.3e}, max abs "
          f"{np.abs(got - want).max():.3e}; bf16 compute vs float32 "
          f"{own:.3e}")
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert 1e-4 < own <= FROM_F32[dot]  # the weights and maps were rounded
    assert _rel(got, want) <= FLIP_SHARE * own


def _declared_casts(fn, *args):
    """``fn`` under ``jax.jit`` without XLA's excess precision, so that it
    rounds at every cast its program states."""
    return np.asarray(jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args))


def _compute_case(rng, voc_cfg, dot, frames):
    """(port output at bf16 compute, at float32, JAX fused output at bf16,
    JAX params, mel) of one seeded tiny vocoder whose units both packages
    route alike."""
    assert all(j == q for j, q in _routes(voc_cfg, frames))
    cfg = jcfg.VocoderConfig(**voc_cfg)
    params = _perturbed(jax.device_get(_fast_init(
        lambda r: JaxBigVGAN(cfg).init(r, jnp.zeros((1, 8, 16))),
        jax.random.PRNGKey(3))), 4)
    state = vocoder_state_from_jax(params, pcfg.VocoderConfig(**voc_cfg))
    mel = (rng.standard_normal((1, frames, 16)) * 0.5).astype(np.float32)
    jvoc = JaxBigVGAN(cfg, dtype=jnp.bfloat16, conv_dtype=JDT[dot], **FUSED)
    want = _declared_casts(jvoc.apply, params, jnp.asarray(mel))
    outs = []
    for dtype in (BF, None):
        voc = BigVGAN(pcfg.VocoderConfig(**voc_cfg), conv_dtype=dot,
                      dtype=dtype).eval()
        voc.load_state_dict(state)
        with torch.no_grad():
            outs.append(voc(torch.from_numpy(mel)).numpy())
    return outs[0], outs[1], want, params, mel


@pytest.mark.parametrize("dot,frames", [(torch.float32, 40),
                                        (torch.bfloat16, 40),
                                        (torch.int8, 8)],
                         ids=["float32", "bfloat16", "int8"])
def test_vocoder_matches_jax_bf16_compute(rng, dot, frames):
    got, f32, want, params, mel = _compute_case(rng, TINY_SHORT, dot, frames)
    _held(got, f32, want, f"AMPBlock1 {dot}", dot)
    if dot != torch.float32:
        return
    # the JAX package's unfused lowering (MelVoco's defaults) adds each
    # conv's f32 bias outside the conv and so keeps f32 maps after it:
    # another function at bf16, further from the fused one than the port
    cfg = jcfg.VocoderConfig(**TINY_SHORT)
    unfused = _declared_casts(JaxBigVGAN(cfg, dtype=jnp.bfloat16).apply,
                              params, jnp.asarray(mel))
    apart = _rel(unfused, want)
    print(f"JAX unfused vs fused lowering at bf16: rel L2 {apart:.3e}")
    assert apart > 1e-3 and _rel(got, want) < FLIP_SHARE * apart


# AMPBlock2 at (4, 2) on an odd number of frames: no stage packs (p = 1),
# so its convs and conv_post are XLA's bf16 conv followed by the f32 bias
TINY_RESBLOCK2_P1 = dict(TINY_RESBLOCK2, upsample_rates=(4, 2),
                         upsample_kernel_sizes=(8, 4))


# packed, AMPBlock2 takes bf16 dots at conv_dtype None too (the JAX
# package's packed_conv1d on bf16 maps), and at p = 1 whatever conv_dtype
# says (XLA's bf16 conv): conv_dtype then changes only the upsamplers'
# dots, which the vocoder above runs at each dtype
@pytest.mark.parametrize("voc_cfg,frames,dot", [
    (TINY_RESBLOCK2, 24, torch.bfloat16),
    (TINY_RESBLOCK2_P1, 21, torch.float32)], ids=["packed", "unpacked"])
def test_resblock2_vocoder_matches_jax_bf16_compute(rng, voc_cfg, frames,
                                                    dot):
    ps = [BigVGAN._pack_factor(16 * 2 ** (1 - i), frames * int(np.prod(
        voc_cfg["upsample_rates"][:i + 1]))) for i in range(2)]
    assert (min(ps) > 1) == (voc_cfg is TINY_RESBLOCK2) and (
        max(ps) == 1) == (voc_cfg is TINY_RESBLOCK2_P1)
    got, f32, want, _, _ = _compute_case(rng, voc_cfg, dot, frames)
    _held(got, f32, want, f"AMPBlock2 {dot}", dot)
    # both sides round the same f32 values at the same places
    assert _rel(got, want) <= 1e-6


def _flow(cfg, frames):
    """(dtypes of each upsampler's input and output; of conv_post's input
    and output, and whether its bias went into the conv; the waveform's
    dtype) in one bf16-compute forward."""
    voc = BigVGAN(cfg, dtype=BF).eval()
    seen = {"convt": [], "post": []}
    saved = (bigvgan.conv_transpose1d, bigvgan.conv1d)

    def convt(x, *a, **kw):
        y = saved[0](x, *a, **kw)
        seen["convt"].append((x.dtype, y.dtype))
        return y

    def conv(x, w, b, **kw):
        y = saved[1](x, w, b, **kw)
        if w.shape[0] == 1:  # conv_post
            seen["post"].append((x.dtype, y.dtype, b is not None))
        return y
    bigvgan.conv_transpose1d, bigvgan.conv1d = convt, conv
    try:
        with torch.no_grad():
            out = voc(torch.zeros(1, frames, cfg.num_mels))
    finally:
        bigvgan.conv_transpose1d, bigvgan.conv1d = saved
    return seen["convt"], seen["post"], out.dtype


def test_dtype_flow_is_the_fused_vocoders():
    # C reads and stores bf16 at every stage; conv_post rounds to bf16 with
    # its bias inside where the JAX package runs it as a Pallas kernel (the
    # last stage packs), and is XLA's bf16 conv with the f32 bias added
    # after it where it does not; the waveform is float32
    packs = pcfg.VocoderConfig(**TINY_VOCODER)
    assert _flow(packs, 4) == ([(BF, BF)] * 2, [(BF, BF, True)],
                               torch.float32)
    flat = pcfg.VocoderConfig(**TINY_RESBLOCK2_P1)
    assert _flow(flat, 5) == ([(BF, BF)] * 2, [(BF, BF, False)],
                              torch.float32)


# --- (d) the entry points -------------------------------------------------------------

TINY_MEL = dict(n_mels=16, n_fft=256, win_length=256, hop_length=16,
                sampling_rate=16000, f_max=8000.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16", jnp.bfloat16])
def test_melvoco_takes_the_bf16_compute_dtype(rng, dtype):
    cfg = pcfg.VocoderConfig(**TINY_VOCODER)
    m = MelVoco(voc_cfg=cfg, dtype=dtype, device="cpu", **TINY_MEL)
    assert m.dtype == m.vocoder.dtype == BF
    assert all(p.dtype == torch.float32 for p in m.vocoder.parameters())
    m.init_vocoder_params(0)
    mel = torch.from_numpy(rng.standard_normal((1, 6, 16)).astype(np.float32))
    out = m.decode(mel)
    assert out.shape == (1, 6 * 16) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    f32 = MelVoco(voc_cfg=cfg, device="cpu", **TINY_MEL)
    f32.vocoder.load_state_dict(m.vocoder.state_dict())
    assert 1e-4 < _rel(out.numpy(), f32.decode(mel).numpy()) < 0.1


@pytest.mark.parametrize("dtype", [torch.float16, "float16", jnp.float16,
                                   torch.int8, "fp32"])
def test_compute_dtype_refuses_other_types(dtype):
    with pytest.raises(ValueError, match="dtype"):
        MelVoco(device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="dtype"):
        BigVGAN(pcfg.VocoderConfig(**TINY_VOCODER), dtype=dtype)
    for ok in (None, torch.float32, "float32", jnp.float32):
        assert BigVGAN(pcfg.VocoderConfig(**TINY_VOCODER),
                       dtype=ok).dtype == torch.float32


def test_chip_smoke_counts_kernel_c_on_bf16_maps():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    cfg = pcfg.VocoderConfig()
    for dot, sfx in ((None, ""), (torch.bfloat16, ".bf16"),
                     (torch.int8, "")):
        calls = chip_smoke.main_path_calls(cfg, 1000, True, dot, None, BF)
        n = {k: sum(v.values()) for k, v in calls.items() if v}
        maps = chip_smoke.main_path_calls(cfg, 1000, True, dot, BF)
        # C reads bf16 at the boundary dtype, five a clip; the rest as on
        # bf16 maps (AMPBlock1 routes the same)
        assert n.pop(f"conv_transpose1d{sfx}@bf16") == 5
        assert n == {k: sum(v.values()) for k, v in maps.items()
                     if v and not k.startswith("conv_transpose1d")}
    assert {"conv_transpose1d@bf16", "conv_transpose1d.bf16@bf16"} <= set(
        chip_smoke.STORAGE_NAMES)


# --- (e) autograd ---------------------------------------------------------------------

def test_bf16_compute_under_autograd_raises_the_jax_error(rng):
    voc = BigVGAN(pcfg.VocoderConfig(**TINY_VOCODER), dtype=BF)
    mel = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match=PALLAS_NO_GRAD):
        voc(mel)
    with torch.no_grad():
        assert torch.isfinite(voc(mel)).all()
    # the JAX package's kernel C on bf16 maps under jax.grad
    x = jnp.asarray(_f32(rng, 1, 8, 16)).astype(jnp.bfloat16)
    wt = jnp.asarray(_f32(rng, 4, 8, 16)).astype(jnp.bfloat16)

    def loss(v):
        return jnp.sum(pallas_packed_conv_transpose1d(
            v, wt, None, stride=2, padding=1, p_in=1, p_out=1,
            interpret=True).astype(jnp.float32))
    with pytest.raises(Exception, match=PALLAS_NO_GRAD):
        jax.grad(loss)(x)
