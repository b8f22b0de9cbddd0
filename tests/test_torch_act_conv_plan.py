"""What surrounds the act->conv core of kernels D and E
(csrc/act_conv_core.cuh: act_conv_mma) on the host, on the CPU: the
staging of its tensor-core route (the activation as [frame][ci] rows over
the tile plus the taps' halo, each tap a row offset, chunks of 8 or 16
channels, kernel B's prepared weights), kernel E's tile and halo, the
accuracy of the 3xTF32 and bf16 tensor-core sums at D's and E's depths, the
Python mirrors of the shared-memory layout and the routing of every
full-width pair and unit, and chip_smoke.py's bounds of D and E."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flowhigh_tpu_torch import FlowHighConfig
from flowhigh_tpu_torch.ops import conv as conv_mod
from flowhigh_tpu_torch.ops import fused_conv
from flowhigh_tpu_torch.ops.quant import round_bf16
from test_torch_convt_plan import _chip_smoke, split

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# (C, T) per stage of a 10 s clip
FULL_WIDTH = [(768, 5000), (384, 20000), (192, 80000), (96, 240000),
              (48, 480000)]


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def mma_route(a, w, dilation, bm, bn, kc, tstart=0, n_out=None):
    """The tensor-core route's GEMM in float64 on a given activation ``a``
    [B, Cin, T] (zero outside [0, T)): per block of ``bm`` output channels
    x ``bn`` samples from ``tstart`` and per chunk of ``kc`` input
    channels, the activation staged as [frame][ci] rows over bn + 2 pad
    frames (zero outside [0, T) and beyond Cin), tap k the row offset k*d,
    the weights from ``conv_weight_layout`` with rows past Cout_p read as
    zeros. Returns [B, Cout, n_out] from position tstart."""
    bsz, cin, t = a.shape
    cout, _, k = w.shape
    pad = dilation * (k - 1) // 2
    wl = conv_mod.conv_weight_layout(w).double()  # [K, Cout_p, Cin_p]
    cout_p, cin_p = wl.shape[1], wl.shape[2]
    assert cin_p % 16 == 0 and -(-cin // kc) * kc <= cin_p
    n_out = t - tstart if n_out is None else n_out
    y = torch.zeros((bsz, cout, n_out), dtype=torch.float64)
    rows = bn + 2 * pad
    for t0 in range(tstart, tstart + n_out, bn):
        for co0 in range(0, cout, bm):
            wb = torch.zeros((k, bm, cin_p), dtype=torch.float64)
            n_rows = max(0, min(bm, cout_p - co0))
            wb[:, :n_rows] = wl[:, co0:co0 + n_rows]
            acc = torch.zeros((bsz, bm, bn), dtype=torch.float64)
            for c0 in range(0, cin, kc):
                stage = torch.zeros((bsz, rows, kc), dtype=torch.float64)
                for u in range(rows):
                    g = t0 - pad + u
                    if 0 <= g < t:
                        n = min(kc, cin - c0)
                        stage[:, u, :n] = a[:, c0:c0 + n, g].double()
                for tap in range(k):
                    xk = stage[:, tap * dilation:tap * dilation + bn]
                    acc += torch.einsum("oc,bnc->bon",
                                        wb[tap, :, c0:c0 + kc], xk)
            hi, m = min(cout, co0 + bm), min(bn, tstart + n_out - t0)
            y[:, co0:hi, t0 - tstart:t0 - tstart + m] = acc[:, :hi - co0, :m]
    return y


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("cin,cout,t", [(20, 256, 300), (12, 128, 100),
                                        (24, 70, 100), (9, 48, 5)])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_pair_staging_equals_conv1d(k, d, cin, cout, t, dot_dtype):
    # kernel D's tiles: Cin off the chunk, T off (and below) the tile, Cout
    # off the 64-row weight padding and the 64-channel block
    gen = np.random.default_rng(k * 100 + d * 10 + cin)
    a = _randn(gen, 2, cin, t)
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    bm, bn = fused_conv._pair_tile(cout, dot_dtype)
    assert (bm, bn) == ((256, 64) if cout % 256 == 0 else
                        (128, 128) if cout % 128 == 0 else (64, 128))
    kc = 16 if dot_dtype == torch.bfloat16 else 8
    got = mma_route(a, w, d, bm, bn, kc)
    want = F.conv1d(a.double(), w.double(), padding=d * (k - 1) // 2,
                    dilation=d)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def _reach6(s):
    """A linear stand-in for act2 with the snake's reach of 6 samples and
    its replicate padding at the sequence's edges: mean of s[n-6 .. n+6]."""
    return F.avg_pool1d(F.pad(s, (6, 6), mode="replicate"), 13, stride=1)


@pytest.mark.parametrize("c", [192, 96, 48, 160])
@pytest.mark.parametrize("k,d", [(3, 5), (11, 1), (7, 3)])
@pytest.mark.parametrize("t", [300, 37])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_unit_tile_reads_only_its_conv1_buffer(c, k, d, t, dot_dtype):
    # kernel E's two phases over tiles of TT = BN - 2 H outputs: conv1 over
    # BN samples from t0 - H into a buffer; act2 reads the buffer at
    # clamp(clamp(g, 0, T - 1) - (t0 - H), 0, BN - 1) (kernel E's SmemSrc);
    # conv2 keeps outputs l < TT. The kept outputs equal the whole
    # sequence's
    gen = np.random.default_rng(c + k + t)
    cs = 8  # channels, cut for the CPU; the tile comes from C
    bm, bn = fused_conv._unit_tile(c, dot_dtype)
    h = fused_conv.unit_halo(k)
    tt = fused_conv.amp_unit_plan(k, d, c, t, dot_dtype)
    assert tt == bn - 2 * h > 0
    a1 = _randn(gen, 1, cs, t)
    w1 = _randn(gen, cs, cs, k, scale=(cs * k) ** -0.5)
    w2 = _randn(gen, cs, cs, k, scale=(cs * k) ** -0.5)
    t1_full = F.conv1d(a1.double(), w1.double(), padding=d * (k - 1) // 2,
                       dilation=d)
    a2 = _reach6(t1_full)
    want = F.conv1d(a2, w2.double(), padding=(k - 1) // 2)
    got = torch.zeros_like(want)
    for t0 in range(0, t, tt):
        buf = mma_route(F.pad(a1, (bn, bn)), w1, d, bm, bn, 8,
                        tstart=bn + t0 - h, n_out=bn)[..., :bn]
        # conv1 beyond [0, T) reads the zero-padded activation, as the
        # kernel's (a1 padded here only to give the tile its positions)
        pos = torch.arange(t0 - h - 6, t0 - h + bn + 6)
        idx = (pos.clamp(0, t - 1) - (t0 - h)).clamp(0, bn - 1)
        src = buf[..., idx]           # the staged window, 6 each side
        act2 = F.avg_pool1d(src, 13, stride=1)   # positions t0 - h ..
        # zero outside [0, T): the conv's padding
        apos = torch.arange(t0 - h, t0 - h + bn)
        act2 = torch.where((apos >= 0) & (apos < t), act2, 0.0)
        y = F.conv1d(act2, w2.double())  # outputs from t0 - h + pad2
        off = h - (k - 1) // 2
        n = min(tt, t - t0)
        got[..., t0:t0 + n] = y[..., off:off + n]
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


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


def core_sum(x, w, d, kc, step):
    """The core's sum over chunks of kc channels and taps, in its order
    (chunk, then tap): ``step(acc, w_k [Cout, kc], x_k [kc, T])``."""
    cin, t = x.shape
    k = w.shape[-1]
    pad = d * (k - 1) // 2
    xp = F.pad(x, (pad, pad))
    acc = torch.zeros((w.shape[0], t))
    for c0 in range(0, cin, kc):
        for tap in range(k):
            acc = step(acc, w[:, c0:c0 + kc, tap],
                       xp[c0:c0 + kc, tap * d:tap * d + t])
    return acc


# D's deepest GEMM (Cin K = 768 x 11, the stage-1 pairs) and E's (C = 192)
DEPTHS = [(768, 11, 5), (192, 11, 5)]


def _within(got, exact, atol=1e-4, rtol=1e-4) -> bool:
    return bool(torch.all((got.double() - exact).abs()
                          <= atol + rtol * exact.abs()))


@pytest.mark.parametrize("cin,k,d", DEPTHS)
def test_3xtf32_with_per_tap_joins_meets_f32_accuracy(cin, k, d):
    # each tap's three TF32 products go into a fresh accumulator (rounded
    # toward zero) and join the sum by an f32 add that rounds to nearest,
    # as mma_3xtf32_1688 does; the activation is split once a chunk
    gen = np.random.default_rng(cin + k)
    x = _randn(gen, cin, 48)
    w = _randn(gen, 8, cin, k, scale=(cin * k) ** -0.5)
    exact = F.conv1d(x[None].double(), w.double(), padding=d * (k - 1) // 2,
                     dilation=d)[0]

    def joined(acc, wk, xk):
        (wh, wl), (xh, xl) = split(wk), split(xk)
        part = mma(mma(mma(torch.zeros_like(acc), wl, xh), wh, xl), wh, xh)
        return (acc.double() + part.double()).float()

    def chained(acc, wk, xk):  # every product through the one accumulator
        (wh, wl), (xh, xl) = split(wk), split(xk)
        return mma(mma(mma(acc, wl, xh), wh, xl), wh, xh)

    def f32(acc, wk, xk):  # exact products, joined by f32 adds
        return (acc.double() + wk.double() @ xk.double()).float()

    got = core_sum(x, w, d, 8, joined)
    assert _within(got, exact)
    err = float((got.double() - exact).abs().max())
    # as accurate as f32 sums of exact products in the same order, within
    # the TF32 split's remainder (2^-22 of each product)
    f32_err = float((core_sum(x, w, d, 8, f32).double() - exact).abs().max())
    assert err < 1.5 * f32_err + 1e-7, (err, f32_err)
    if cin == 768:  # at D's depth the toward-zero sums drift further
        drift = float((core_sum(x, w, d, 8, chained).double()
                       - exact).abs().max())
        assert drift > 2 * err, (drift, err)


@pytest.mark.parametrize("cin,k,d", DEPTHS)
def test_bf16_tensor_core_sums_meet_the_bound(cin, k, d):
    # the BF16 route keeps the tensor cores' own sums: one m16n8k16 step a
    # tap and 16-channel chunk, each rounded toward zero, against the bf16
    # plain version's exact sums of the rounded operands
    gen = np.random.default_rng(cin + k + 1)
    x, w = _randn(gen, cin, 48), _randn(gen, 8, cin, k,
                                        scale=(cin * k) ** -0.5)
    xb, wb = round_bf16(x), round_bf16(w)
    exact = F.conv1d(xb[None].double(), wb.double(),
                     padding=d * (k - 1) // 2, dilation=d)[0]
    got = core_sum(xb, wb, d, 16, mma)
    assert _within(got, exact)
    assert float((got.double() - exact).abs().max()) < 3e-5


# --- the shared-memory mirrors and the routing -------------------------------------

@pytest.mark.parametrize("k,d,c,dot_dtype,want", [
    # kernel D at C = 768, bf16, the widest window: 3 x 256 x 32 bytes of
    # weights, two buffers (the cluster's) of 114 rows of 48 bytes, 2 x 16
    # x 126 raw floats, 8 x 2 x 120 signal floats and 64 parameters: two
    # blocks an SM
    (11, 5, 768, torch.bfloat16, 59584),
    # kernel E at C = 192, bf16, k = 11, d = 5: 192 x 192 floats of conv1
    # output plus the pass's working set
    (11, 5, 192, torch.bfloat16, 147456 + 78688)])
def test_smem_mirrors_at_the_widest_shapes(k, d, c, dot_dtype, want):
    fn = (fused_conv.act_conv_smem_bytes if c == 768
          else fused_conv.amp_unit_smem_bytes)
    assert fn(k, d, c, dot_dtype) == want


def test_mma_core_layout_adds_up():
    # ring, activation rows (two buffers in a cluster), raw stages, signal,
    # parameters
    for bf16, kc, row in ((False, 8, 80), (True, 16, 48)):
        for pad in (1, 25):
            for bm, bn in ((128, 128), (192, 192), (48, 256)):
                for n_act in (1, 2):
                    aw = bn + 2 * pad
                    assert fused_conv.mma_core_smem_bytes(
                        pad, bn, bm, bf16, cluster=n_act == 2) == (
                        3 * bm * 32 + n_act * aw * row
                        + 4 * (2 * kc * (aw + 12) + 8 * 2 * (aw + 6)
                               + 4 * kc))


@pytest.mark.parametrize("c,t", FULL_WIDTH)
def test_every_full_width_pair_and_unit_routes_as_before(c, t):
    # pairs go to D at every stage and dtype; units to E at C <= 192, at
    # every dtype alike; D's tensor-core instances leave room for two
    # blocks an SM at the stages the vocoder sends it
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            assert {bool(fused_conv.act_conv_plan(k, d, c, t, dt))
                    for dt in DTYPES} == {True}
            assert {bool(fused_conv.amp_unit_plan(k, d, c, t, dt))
                    for dt in DTYPES} == {c <= 192}
            for dt in DTYPES[:2]:
                assert fused_conv.act_conv_smem_bytes(k, d, c, dt) \
                    <= fused_conv.SMEM_PER_BLOCK // 2
                if c <= 96 and dt == torch.bfloat16:  # E: two blocks
                    assert fused_conv.amp_unit_smem_bytes(k, d, c, dt) \
                        <= fused_conv.SMEM_PER_BLOCK // 2
    if c == 192:  # one 192-channel pass: each activation once a sample
        assert fused_conv._unit_tile(c) == (192, 192)
        assert fused_conv._unit_tile(c, torch.int8) == (96, 256)


# --- chip_smoke.py's bounds of D and E ------------------------------------------------

@pytest.mark.parametrize("instance,launches,dots_tflop,bound_ms", [
    # 3xTF32: three TF32 products per f32 product at 495 TFLOP/s, plus the
    # snake and the epilogue at the f32 peak
    ("act_conv1d", 36, 1.48636, 9.19),
    ("amp_unit", 27, 1.57925, 10.52),
    ("act_conv1d.bf16", 36, 1.48636, 1.69),
    ("amp_unit.bf16", 27, 1.57925, 2.58)])
def test_chip_smoke_bounds_d_and_e_by_their_route(instance, launches,
                                                  dots_tflop, bound_ms):
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    dt = cs.dot_dtype_of(instance)
    calls = cs.main_path_calls(FlowHighConfig().vocoder, 1000, True,
                               None if dt == torch.float32 else dt)[instance]
    assert sum(calls.values()) == launches
    total = dots = 0.0
    for key, n in calls.items():
        byt, dk, other = cs.work(instance, key)
        dots += n * dk
        ops_s = cs.dot_seconds(peaks, instance, dk, key) + other / peaks[0]
        total += n * max(byt / peaks[1], ops_s) * 1e3
    assert dots == pytest.approx(dots_tflop * 1e12, rel=1e-4)
    assert total == pytest.approx(bound_ms, abs=0.01)


# --- the device-time profile's kernel groups ------------------------------------------

@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::act_conv1d_mma_kernel<(Dot)0, 11, 256, 64, "
     "8, false>(float const*, ...)", "kernel D: act_conv1d"),
    ("void (anonymous namespace)::act_conv1d_kernel<(Dot)2, 3, 8, 8, 16>(...)",
     "kernel D: act_conv1d"),
    ("void (anonymous namespace)::amp_unit_mma_kernel<(Dot)1, 7, 96, 128, 2>"
     "(...)", "kernel E: amp_unit"),
    ("void (anonymous namespace)::amp_unit_kernel<(Dot)2, 3, 4, 6, 16>(...)",
     "kernel E: amp_unit"),
    ("void (anonymous namespace)::conv1d_mma_kernel<(Dot)0, 11, 2, 2>(...)",
     "kernel B: conv1d_same")])
def test_profile_groups_d_and_e_by_name(name, group):
    # the tensor-core instances of D and E carry "mma" in their names, as
    # kernel B's GEMM route does; they are still counted as D and E
    from flowhigh_tpu_torch.profiling import _group
    assert _group(name) == group
