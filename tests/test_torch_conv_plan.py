"""What surrounds kernel B (csrc/conv1d_same.cu) on the host, on the CPU:
its staging plan (x as [frame][ci] with a zero halo, each tap a row
offset), the narrow route's window, its weight layout and cache, the
accuracy of the 3xTF32 and bf16 tensor-core sums its GEMM route takes on
the card, chip_smoke.py's bound of it; and the int8 activation in the
kernels' order (``snake_activation1d_ordered``) against the JAX package's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from flowhigh_tpu.ops.fused_act import fused_snake_activation1d
from flowhigh_tpu_torch import FlowHighConfig, ops
from flowhigh_tpu_torch.ops import conv as conv_mod
from flowhigh_tpu_torch.ops.fused_act import snake_activation1d_ordered
from flowhigh_tpu_torch.ops.quant import round_bf16
from test_torch_convt_plan import _chip_smoke, split, tf32

BN = 256  # the GEMM route's frames a block (csrc/conv1d_same.cu)
NB, NCC = 512, 8  # the narrow route's outputs a block, channels a stage


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def tile_co(cout: int) -> int:
    """The GEMM route's output channels a block (``launch_mma_k``)."""
    return 48 if cout % 48 == 0 and cout % 64 != 0 else 64


def gemm_route(x, w, b, dilation, kc=8):
    """Kernel B's GEMM route in float64: per block of tile_co(Cout) channels
    x BN frames and per chunk of ``kc`` input channels, x staged as
    [frame][ci] over the block's frames plus the taps' reach (zero outside
    [0, T) and beyond Cin), tap k the row offset k*d, weights from
    ``conv_weight_layout``."""
    bsz, cin, t = x.shape
    cout, _, k = w.shape
    pad = dilation * (k - 1) // 2
    wl = conv_mod.conv_weight_layout(w).double()  # [K, Cout_p, Cin_p]
    cin_p, tc = wl.shape[2], tile_co(cout)
    assert -(-cout // tc) * tc <= wl.shape[1]  # no tile reads past Cout_p
    y = torch.zeros((bsz, cout, t), dtype=torch.float64)
    rows = BN + 2 * pad
    for t0 in range(0, t, BN):
        for co0 in range(0, cout, tc):
            acc = torch.zeros((bsz, tc, BN), dtype=torch.float64)
            for c0 in range(0, cin_p, kc):
                stage = torch.zeros((bsz, rows, kc), dtype=torch.float64)
                for u in range(rows):
                    g = t0 - pad + u
                    if 0 <= g < t:
                        n = max(0, min(kc, cin - c0))
                        stage[:, u, :n] = x[:, c0:c0 + n, g].double()
                for tap in range(k):
                    wk = wl[tap, co0:co0 + tc, c0:c0 + kc]      # [tc, kc]
                    xk = stage[:, tap * dilation:tap * dilation + BN]
                    acc += torch.einsum("oc,bnc->bon", wk, xk)
            hi, n = min(cout, co0 + tc), min(BN, t - t0)
            y[:, co0:hi, t0:t0 + n] = acc[:, :hi - co0, :n]
    return y if b is None else y + b.double()[:, None]


def narrow_route(x, w, b, dilation):
    """Kernel B's narrow route in float64: per block of NB outputs, x
    staged by chunks of NCC channels over [t0 - halo, t0 + NB + halo), halo
    the reach rounded up to 4, each thread's outputs t0 + tid + 128 j."""
    bsz, cin, t = x.shape
    cout, _, k = w.shape
    pad = dilation * (k - 1) // 2
    halo = (pad + 3) // 4 * 4
    width = NB + 2 * halo
    y = torch.zeros((bsz, cout, t), dtype=torch.float64)
    for t0 in range(0, t, NB):
        acc = torch.zeros((bsz, cout, NB), dtype=torch.float64)
        for c0 in range(0, cin, NCC):
            stage = torch.zeros((bsz, NCC, width), dtype=torch.float64)
            lo, hi = max(0, t0 - halo), min(t, t0 - halo + width)
            n = min(NCC, cin - c0)
            stage[:, :n, lo - (t0 - halo):hi - (t0 - halo)] = \
                x[:, c0:c0 + n, lo:hi].double()
            for tap in range(k):
                off = halo - pad + tap * dilation
                acc += torch.einsum("oc,bcn->bon",
                                    w[:, c0:c0 + n, tap].double(),
                                    stage[:, :n, off:off + NB])
        m = min(NB, t - t0)
        y[..., t0:t0 + m] = acc[..., :m]
    return y if b is None else y + b.double()[:, None]


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("cout", [48, 96, 70])
def test_gemm_route_staging_equals_conv1d(k, d, cout):
    # batch 2, Cin off the 8-channel chunk, T off the 256-frame tile
    gen = np.random.default_rng(k * 100 + d * 10 + cout)
    cin, t = 20, 300
    x = _randn(gen, 2, cin, t)
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    b = _randn(gen, cout, scale=0.1)
    want = F.conv1d(x.double(), w.double(), b.double(),
                    padding=d * (k - 1) // 2, dilation=d)
    torch.testing.assert_close(gemm_route(x, w, b, d), want, atol=1e-12,
                               rtol=1e-12)


@pytest.mark.parametrize("k,d,cin,t", [(7, 1, 48, 1100), (5, 2, 21, 3),
                                       (11, 5, 9, 513)])
def test_narrow_route_window_equals_conv1d(k, d, cin, t):
    gen = np.random.default_rng(k + t)
    x = _randn(gen, 2, cin, t)
    w = _randn(gen, 1, cin, k, scale=(cin * k) ** -0.5)
    b = _randn(gen, 1, scale=0.1)
    want = F.conv1d(x.double(), w.double(), b.double(),
                    padding=d * (k - 1) // 2, dilation=d)
    torch.testing.assert_close(narrow_route(x, w, b, d), want, atol=1e-12,
                               rtol=1e-12)


def test_tile_rows_cover_the_vocoder_stages():
    # 48-channel tiles only where 64 does not divide C, and each a whole
    # number of tiles there: no tile row idles at the C = 48, 96 stages
    assert [tile_co(c) for c in (768, 384, 192, 96, 48)] == [64] * 3 + [48] * 2
    for c in (96, 48):
        assert c % tile_co(c) == 0


@pytest.mark.parametrize("cout,cin,k", [(768, 768, 11), (48, 48, 7),
                                        (96, 96, 3), (70, 20, 7)])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_round_trips(cout, cin, k, dot_dtype):
    w = _randn(np.random.default_rng(cout + k), cout, cin, k)
    lay = conv_mod.conv_weight_layout(w, dot_dtype)
    cin_p = -(-cin // conv_mod.CONV_CIN_ALIGN) * conv_mod.CONV_CIN_ALIGN
    cout_p = -(-cout // conv_mod.CONV_COUT_ALIGN) * conv_mod.CONV_COUT_ALIGN
    assert lay.shape == (k, cout_p, cin_p) and lay.is_contiguous()
    assert lay.dtype == dot_dtype
    want = w if dot_dtype == torch.float32 else round_bf16(w)
    assert torch.equal(lay[:, :cout, :cin].float().permute(1, 2, 0), want)
    assert not lay[:, cout:].any() and not lay[:, :, cin:].any()


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_is_cached_by_version(dot_dtype):
    w = _randn(np.random.default_rng(1), 48, 24, 7)
    first = conv_mod.conv_weights(w, dot_dtype)
    assert conv_mod.conv_weights(w, dot_dtype) is first
    with torch.no_grad():
        w.mul_(2.0)  # an in-place write bumps the version counter
    again = conv_mod.conv_weights(w, dot_dtype)
    assert again is not first
    assert torch.equal(again.float(), 2.0 * first.float())
    # beside the other instance's and kernel C's layouts, not in their place
    other = torch.bfloat16 if dot_dtype == torch.float32 else torch.float32
    assert conv_mod.conv_weights(w, other).dtype == other
    assert conv_mod.convt_weights(w, dot_dtype).shape[1:] == (64, 48)
    assert conv_mod.conv_weights(w, dot_dtype) is again


# --- the tensor cores' sums, emulated ------------------------------------------------

def rz(exact: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero: the tensor cores' sums."""
    f = exact.float()
    over = f.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma(c, a, b):
    """One mma.sync step: c (f32) plus the exact products a [M, k] b [k, N],
    rounded toward zero."""
    return rz(c.double() + a.double() @ b.double())


def stage1(gen, cout=8, t=48):
    """Stage 1's deepest conv: Cin 768, K 11, d 5, over a narrow Cout, T;
    returns x, w and the exact result (float64)."""
    cin, k, d = 768, 11, 5
    x = _randn(gen, cin, t)
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    exact = F.conv1d(x[None].double(), w.double(), padding=d * (k - 1) // 2,
                     dilation=d)[0]
    return x, w, exact, d


def tensor_core_conv(x, w, d, step):
    """The GEMM route's sum over chunks and taps: ``step(acc, w_k [Cout,
    kc], x_k [kc, T])`` for each tap k of each chunk of kc channels, in the
    kernel's order (chunk, then tap)."""
    cin, t = x.shape
    k = w.shape[-1]
    pad = d * (k - 1) // 2
    xp = F.pad(x, (pad, pad))
    acc = torch.zeros((w.shape[0], t))
    for c0 in range(0, cin, 8):
        for tap in range(k):
            acc = step(acc, w[:, c0:c0 + 8, tap],
                       xp[c0:c0 + 8, tap * d:tap * d + t])
    return acc


def _within(got, exact, atol=1e-4, rtol=1e-4) -> bool:
    return bool(torch.all((got.double() - exact).abs()
                          <= atol + rtol * exact.abs()))


def test_3xtf32_with_per_tap_joins_meets_f32_accuracy_at_stage1_depth():
    # Cin K = 8,448: each tap's three TF32 products go into a fresh
    # accumulator (rounded toward zero) and join the sum by an f32 add that
    # rounds to nearest, as mma_3xtf32_1688 does
    x, w, exact, d = stage1(np.random.default_rng(3))

    def joined(acc, wk, xk):
        (wh, wl), (xh, xl) = split(wk), split(xk)
        part = mma(mma(mma(torch.zeros_like(acc), wl, xh), wh, xl), wh, xh)
        return (acc.double() + part.double()).float()

    def chained(acc, wk, xk):  # every product through the one accumulator
        (wh, wl), (xh, xl) = split(wk), split(xk)
        return mma(mma(mma(acc, wl, xh), wh, xl), wh, xh)

    def one(acc, wk, xk):  # a single TF32 product
        return (acc.double() + tf32(wk).double() @ tf32(xk).double()).float()

    got = tensor_core_conv(x, w, d, joined)
    assert _within(got, exact)
    err = float((got.double() - exact).abs().max())
    assert err < 2e-6, err
    # the sums rounded toward zero alone drift further than the joined ones
    drift = float((tensor_core_conv(x, w, d, chained).double()
                   - exact).abs().max())
    assert drift > 2 * err, (drift, err)
    # one TF32 product misses the card's 1e-4
    assert not _within(tensor_core_conv(x, w, d, one), exact)


def test_bf16_tensor_core_sums_meet_the_bound_at_stage1_depth():
    # B.bf16 keeps the tensor cores' own sums (no per-tap joins): 528
    # m16n8k16 steps at stage 1, each rounded toward zero, against the bf16
    # plain version's exact sums of the rounded operands
    x, w, _, d = stage1(np.random.default_rng(4))
    xb, wb = round_bf16(x), round_bf16(w)
    exact = F.conv1d(xb[None].double(), wb.double(),
                     padding=d * (w.shape[-1] - 1) // 2, dilation=d)[0]
    cin, t = x.shape
    k = w.shape[-1]
    pad = d * (k - 1) // 2
    xp = F.pad(xb, (pad, pad))
    acc = torch.zeros((w.shape[0], t))
    for c0 in range(0, cin, 16):
        for tap in range(k):
            acc = mma(acc, wb[:, c0:c0 + 16, tap],
                      xp[c0:c0 + 16, tap * d:tap * d + t])
    assert _within(acc, exact)
    assert float((acc.double() - exact).abs().max()) < 3e-5


# --- chip_smoke.py's bound ------------------------------------------------------------

@pytest.mark.parametrize("instance,bound_ms,bound_by", [
    # 3.07 TFLOP of products per clip as 3xTF32 at 495 TFLOP/s, plus the
    # epilogue; conv_post by bytes
    ("conv1d_same", 18.83, "operations"),
    # bf16: bytes at 3.35 TB/s exceed the tensor cores' time
    ("conv1d_same.bf16", 5.15, "bytes"),
    # int8: the same products at the s8 peak, by bytes; conv_post stays
    # float32, so 90 launches
    ("conv1d_same.int8", 4.36, "bytes")])
def test_chip_smoke_bounds_kernel_b_by_its_route(instance, bound_ms, bound_by):
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    dt = cs.dot_dtype_of(instance)
    calls = cs.main_path_calls(FlowHighConfig().vocoder, 1000, False,
                               None if dt == torch.float32 else dt)[instance]
    assert sum(calls.values()) == (90 if dt == torch.int8 else 91)
    total = dots = 0.0
    for key, n in calls.items():
        byt, dk, other = cs.work(instance, key)
        ops_s = cs.dot_seconds(peaks, instance, dk, key) + other / peaks[0]
        if key[1] == 1:  # conv_post: the narrow route, FMA units, bytes
            assert cs.dot_seconds(peaks, instance, dk, key) == \
                pytest.approx(dk / peaks[0])
            assert byt / peaks[1] > ops_s
            assert byt / peaks[1] * 1e3 == pytest.approx(0.028, abs=5e-4)
        else:
            dots += n * dk
        total += n * max(byt / peaks[1], ops_s) * 1e3
    assert dots == pytest.approx(3.0656e12, rel=1e-4)
    assert total == pytest.approx(bound_ms, abs=0.01)
    tot = cs.path_totals({instance: calls}, {instance: {
        key: _row(cs, peaks, instance, key) for key in calls}})[instance]
    assert tot["bound_by"] == bound_by
    # the GEMM route's f32 products: three TF32 products at the TF32 peak;
    # int8's one s8 product at the int8 peak
    assert cs.dot_seconds(peaks, "conv1d_same", 495e12, (768, 768)) == \
        pytest.approx(3.0)
    assert cs.dot_seconds(peaks, "conv1d_same.int8", 1979e12,
                          (768, 768)) == pytest.approx(1.0)


def _row(cs, peaks, instance, key):
    byt, dots, other = cs.work(instance, key)
    return {"bytes_ms": byt / peaks[1] * 1e3,
            "ops_ms": (cs.dot_seconds(peaks, instance, dots, key)
                       + other / peaks[0]) * 1e3,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "unfused_chain_ms": None}


def test_kernel_b_rows_group_by_resblock_shape():
    # phase 1's rows of B: one per (stage, K, d) and conv_post
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    calls = cs.main_path_calls(FlowHighConfig().vocoder, 1000, False)
    calls = {"conv1d_same": calls["conv1d_same"]}
    rows = {"conv1d_same": {k: _row(cs, peaks, "conv1d_same", k)
                            for k in calls["conv1d_same"]}}
    tot = cs.path_totals(calls, rows)["conv1d_same"]
    groups = cs.conv_groups(tot)
    assert len(groups) == 5 * 3 * 3 + 1
    assert sum(g["launches"] for g in groups.values()) == 91
    # (K, d = 1) holds the d = 1 unit's conv1 and all three units' conv2
    assert groups[(768, 5000, 3, 1)]["launches"] == 4
    assert groups[(48, 1, 480000, 7, 1, 0, 1.0)]["launches"] == 1


# --- the int8 activation in the kernels' order -----------------------------------------

@pytest.mark.parametrize("t", [1, 2, 5, 37, 300])
@pytest.mark.parametrize("with_beta,logscale", [(True, True), (False, True),
                                                (True, False)])
def test_ordered_act_equals_plain_to_f32_rounding(t, with_beta, logscale):
    gen = np.random.default_rng(t)
    x = _randn(gen, 2, 6, t)
    a = _randn(gen, 6, scale=0.3)
    b = _randn(gen, 6, scale=0.3) if with_beta else None
    if not logscale:
        a = a.abs() + 0.5
        b = None if b is None else b.abs() + 0.5
    got = snake_activation1d_ordered(x, a, b, logscale)
    want = ops.snake_activation1d_plain(x, a, b, logscale)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("with_beta,logscale", [(True, True), (False, False)])
def test_ordered_act_matches_fused_pallas(with_beta, logscale):
    # the JAX package's anti-aliased snake in interpret mode, at
    # tests/test_torch_ops.py's bound (f32 reassociation and the Pallas
    # kernel's polynomial cos)
    gen = np.random.default_rng(7)
    x = gen.standard_normal((2, 32, 96)).astype(np.float32)
    a = (gen.standard_normal(32) * 0.3).astype(np.float32)
    b = (gen.standard_normal(32) * 0.3).astype(np.float32) if with_beta \
        else None
    if not logscale:
        a = np.abs(a) + 0.5
    want = np.asarray(fused_snake_activation1d(
        jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(a),
        None if b is None else jnp.asarray(b), logscale, True))
    got = snake_activation1d_ordered(
        torch.from_numpy(x), torch.from_numpy(a),
        None if b is None else torch.from_numpy(b), logscale).numpy()
    np.testing.assert_allclose(np.swapaxes(got, 1, 2), want, atol=2e-5,
                               rtol=1e-4)


def test_int8_plain_versions_take_the_ordered_act(monkeypatch):
    # D.int8's and E.int8's plain versions quantise the ordered act; the
    # float32 and bfloat16 ones keep the plain act
    from flowhigh_tpu_torch.ops import fused_conv
    seen = []

    def spy(x, *args):
        seen.append(x.shape)
        return snake_activation1d_ordered(x, *args)

    monkeypatch.setattr(fused_conv, "snake_activation1d_ordered", spy)
    gen = np.random.default_rng(5)
    c, k, t = 16, 3, 40
    x = _randn(gen, 1, c, t)
    a, b = _randn(gen, c, scale=0.3), _randn(gen, c, scale=0.3)
    w = _randn(gen, c, c, k, scale=(c * k) ** -0.5)
    ops.act_conv1d_plain(x, a, b, True, w, None, dilation=1,
                         dot_dtype=torch.int8)
    assert len(seen) == 1
    ops.amp_unit_plain(x, a, b, a, b, True, w, None, w, None, dilation=1,
                       dot_dtype=torch.int8)
    assert len(seen) >= 3  # act1, and act2 of every tile's conv1 output
    n = len(seen)
    for dt in (torch.float32, torch.bfloat16):
        ops.act_conv1d_plain(x, a, b, True, w, None, dilation=1, dot_dtype=dt)
        ops.amp_unit_plain(x, a, b, a, b, True, w, None, w, None, dilation=1,
                           dot_dtype=dt)
    assert len(seen) == n
