"""What surrounds kernel B.int8 (csrc/conv1d_same.cu: the I8 instance of
the GEMM route, conv1d_s8_kernel, and its pre-pass conv1d_amax_kernel) on
the host, on the CPU: the s8 route emulated in integers (prepared weights
[K][Cout_p][Cin_p], 32-channel chunks, tiles of 64 or 48 channels x 256
frames that are the int8 windows, tap k a frame offset, sums in int64)
against the plain version bit for bit, the pre-pass's plain twin, the
Python mirror of its shared memory at every full-width shape, its routing
on the unfused int8 path, and chip_smoke.py's gates and bound of it."""

import numpy as np
import pytest
import torch

from flowhigh_tpu_torch import FlowHighConfig
from flowhigh_tpu_torch.ops import conv as conv_mod
from flowhigh_tpu_torch.ops import quant
from test_torch_conv_plan import tile_co
from test_torch_convt_plan import _chip_smoke

I8 = torch.int8
BN = 256  # the GEMM route's frames a block: the int8 window
FULL_WIDTH = [768, 384, 192, 96, 48]
RESBLOCKS = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def b_s8_route(x, w, b, dilation, residuals=(), out_scale=1.0, kc=32):
    """Kernel B.int8 on x [B, Cin, T] as the card runs it: each 256-frame
    tile takes its window's scale from the pre-pass's partial maxima
    (``conv1d_amax_plain``), quantises x over the tile plus the taps'
    reach once (zero outside [0, T) and past Cin), and per block of
    tile_co(Cout) output channels and chunk of ``kc`` input channels sums
    the prepared int8 weights [K, Cout_p, Cin_p] tap by tap (tap k the
    frame offset k d) in int64; then float(acc) * (s_x * s_w[co]), + bias,
    + residuals, x out_scale."""
    bsz, cin, t = x.shape
    cout, _, k = w.shape
    pad = dilation * (k - 1) // 2
    wl = conv_mod.conv_weight_layout(w, I8)
    assert wl.dtype == I8 and wl.shape[2] % kc == 0
    cout_p, cin_p = wl.shape[1], wl.shape[2]
    s_w = quant.int8_weights(w)[1]
    tc = tile_co(cout)
    assert -(-cout // tc) * tc <= cout_p  # no tile reads past Cout_p
    part = conv_mod.conv1d_amax_plain(x, k, dilation)     # [B, n, groups]
    rows = BN + 2 * pad
    y = torch.zeros((bsz, cout, t))
    for wi, t0 in enumerate(range(0, t, BN)):
        amax = torch.clamp(part[:, wi].amax(dim=-1), min=1e-30)   # [B]
        c127 = torch.full_like(amax, 127.0)
        qs, s_x = c127 / amax, amax / c127
        stage = torch.zeros((bsz, cin_p, rows))
        lo, hi = max(0, t0 - pad), min(t, t0 + BN + pad)
        stage[:, :cin, lo - (t0 - pad):hi - (t0 - pad)] = x[:, :, lo:hi]
        aq = torch.round(stage * qs[:, None, None]).to(torch.int64)
        assert aq.abs().max() <= 127
        for co0 in range(0, cout, tc):
            acc = torch.zeros((bsz, tc, BN), dtype=torch.int64)
            for c0 in range(0, cin_p, kc):
                for tap in range(k):
                    wk = wl[tap, co0:co0 + tc, c0:c0 + kc].to(torch.int64)
                    xk = aq[:, c0:c0 + kc, tap * dilation:tap * dilation + BN]
                    acc += torch.einsum("oc,bcn->bon", wk, xk)
            assert acc.abs().max() < 2 ** 31  # exact in the card's int32
            n, hi_co = min(BN, t - t0), min(cout, co0 + tc)
            fac = s_x[:, None] * s_w[None, co0:hi_co]            # [B, co]
            y[:, co0:hi_co, t0:t0 + n] = (acc[:, :hi_co - co0, :n].float()
                                          * fac[..., None])
    if b is not None:
        y = y + b[:, None]
    for r in residuals:
        y = y + r
    return y if out_scale == 1.0 else y * out_scale


@pytest.mark.parametrize("k,d", RESBLOCKS)
def test_s8_route_equals_the_plain_version(k, d):
    # Cin off the 32-channel chunk, Cout below the 64-channel tile, T off
    # the 256-frame window, batch 2 with a zero window on its second row
    gen = np.random.default_rng(k * 10 + d)
    cin, cout, t = 45, 40, 300
    x = _randn(gen, 2, cin, t)
    x[1, :, :200] = 0.0
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    b = _randn(gen, cout, scale=0.1)
    res = tuple(_randn(gen, 2, cout, t) for _ in range(k % 4))
    kw = dict(dilation=d, residuals=res, out_scale=0.5)
    got = b_s8_route(x, w, b, **kw)
    want = conv_mod.conv1d_plain(x, w, b, dot_dtype=I8, **kw)
    assert torch.equal(got, want)
    # the plain version is quant.conv1d_int8 plus the f32 epilogue
    base = quant.conv1d_int8(x, w, dilation=d, tile=BN) + b[:, None]
    for r in res:
        base = base + r
    assert torch.equal(want, base * 0.5)


@pytest.mark.parametrize("cin,cout,t,k,d", [(96, 48, 77, 11, 5),
                                            (64, 96, 513, 3, 3),
                                            (32, 200, 256, 7, 1)])
def test_s8_route_tiles_of_48_and_64_channels(cin, cout, t, k, d):
    # 48-channel tiles (C = 48, 96), 64-channel tiles with a partial one
    # (200), T below one window and exactly one
    gen = np.random.default_rng(cin + cout + t)
    x = _randn(gen, 1, cin, t)
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    got = b_s8_route(x, w, None, d)
    assert torch.equal(got, conv_mod.conv1d_plain(x, w, None, dilation=d,
                                                  dot_dtype=I8))


# --- the window scales' pre-pass --------------------------------------------

@pytest.mark.parametrize("c,t,k,d", [(45, 777, 7, 3), (16, 300, 11, 5),
                                     (48, 37, 3, 1), (20, 600, 3, 5)])
def test_pre_pass_plain_twin_gives_the_plain_versions_amax(c, t, k, d):
    gen = np.random.default_rng(c + t)
    x = _randn(gen, 2, c, t)
    x[1, :, 256:] = 0.0  # windows of zeros on the second row
    pad = d * (k - 1) // 2
    n = -(-t // BN)
    part = conv_mod.conv1d_amax_plain(x, k, d)
    assert part.shape == (2, n, -(-c // conv_mod.AMAX_CH))
    want = quant.windows(x, -pad, BN + 2 * pad, BN, n).abs().amax(dim=(2, 3))
    assert torch.equal(part.amax(dim=-1), want)
    for g in range(part.shape[-1]):  # each partial: its 8 channels
        sl = slice(8 * g, 8 * g + 8)
        assert torch.equal(part[..., g], quant.windows(
            x[:, sl], -pad, BN + 2 * pad, BN, n).abs().amax(dim=(2, 3)))


def test_pre_pass_scale_maps_each_windows_largest_value_to_127():
    gen = np.random.default_rng(5)
    x = _randn(gen, 1, 24, 768)
    x[..., 510:] = 0.0  # window 2 with its halo is all zero
    amax = torch.clamp(conv_mod.conv1d_amax_plain(x, 3, 1).amax(dim=-1),
                       min=1e-30)
    win = quant.windows(x, -1, 258, 256, 3)
    aq = torch.round(win * (torch.full_like(amax, 127.0) / amax)[..., None,
                                                                  None])
    assert aq[0, :2].abs().amax(dim=(1, 2)).tolist() == [127.0, 127.0]
    assert amax[0, 2] == 1e-30 and not aq[0, 2].any()


# --- shared memory ---------------------------------------------------------------

@pytest.mark.parametrize("k,d", RESBLOCKS)
@pytest.mark.parametrize("c", FULL_WIDTH)
def test_int8_smem_fits_every_full_width_shape(c, k, d):
    # two blocks an SM at every resblock shape of the vocoder: two stages
    # of K x tc weight rows and rows int8 x rows of 32 bytes, one f32
    # staging buffer of rows x 33 floats; the output tile reuses them
    rows = 256 + d * (k - 1)
    tc = tile_co(c)
    got = conv_mod.conv_smem_bytes(k, d, c, I8)
    assert got == max(2 * (k * tc * 32 + rows * 32)
                      + -(-rows * 132 // 16) * 16, tc * 264 * 4)
    assert got <= conv_mod.SMEM_PER_BLOCK // 2
    # every instance of the route fits at these shapes
    for dt in (torch.float32, torch.bfloat16):
        assert conv_mod.conv_smem_bytes(k, d, c, dt) <= \
            conv_mod.SMEM_PER_BLOCK


@pytest.mark.parametrize("k,d,c,dot_dtype,want", [
    # 768 channels, K 11, d 5: 2 x (11 x 64 x 32 + 306 x 32) + 306 x 132
    # (40,392, to 40,400) bytes
    (11, 5, 768, I8, 105040),
    # K 3, d 1: the output tile, 64 x 264 floats, is the larger
    (3, 1, 768, I8, 67584),
    # 48-channel tiles (C = 96, 48)
    (11, 5, 96, I8, 93776), (3, 1, 48, I8, 59792),
    # the float32 and bfloat16 instances at the widest shape
    (11, 5, 768, torch.float32, 94016), (11, 5, 768, torch.bfloat16, 98912)])
def test_conv_smem_pinned(k, d, c, dot_dtype, want):
    assert conv_mod.conv_smem_bytes(k, d, c, dot_dtype) == want


# --- routing and chip_smoke.py ----------------------------------------------------

def test_unfused_int8_path_keeps_b_int8_at_90_launches():
    cs = _chip_smoke()
    cfg = FlowHighConfig().vocoder
    unfused = cs.main_path_calls(cfg, 1000, False, I8)
    calls = unfused["conv1d_same.int8"]
    assert sum(calls.values()) == 90
    for cin, cout, t, k, d, n_res, _ in calls:
        assert cin == cout >= 48 and k in (3, 7, 11) and n_res <= 3
        assert conv_mod.conv_smem_bytes(k, d, cout, I8) <= \
            conv_mod.SMEM_PER_BLOCK // 2
    assert sum(unfused["conv1d_same"].values()) == 1  # conv_post, float32
    fused = cs.main_path_calls(cfg, 1000, True, I8)
    assert not fused["conv1d_same.int8"]  # no B.int8 on the default path
    assert sum(fused["act_conv1d.int8"].values()) == 36
    assert sum(fused["amp_unit.int8"].values()) == 27


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a1b2c3d4_14_conv1d_same_cu_0f1e2d3c18conv1d_amax_kernelEPKfPfiii' for 'sm_90a'
ptxas info    : Used 18 registers, used 1 barriers, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a1b2c3d4_14_conv1d_same_cu_0f1e2d3c16conv1d_s8_kernelILi11ELi2ELi2EEvPKfPKaS2_S2_iS2_S2_S2_S2_Pfiiiif' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a1b2c3d4_14_conv1d_same_cu_0f1e2d3c17conv1d_mma_kernelILN12_GLOBAL__N_13DotE0ELi11ELi2ELi2EEEvPKfPKNS_4GemmIXT_EXT1_EXT2_EE2WTES3_S3_S3_S3_Pfiiiif' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers, 0 bytes spill stores, 0 bytes spill loads
"""


def test_chip_smoke_gates_b_int8_and_its_pre_pass_on_spills():
    cs = _chip_smoke()
    entries = cs.ptxas_entries(PTXAS_LOG)
    assert [(k, a, r, sp) for k, a, r, sp in entries] == [
        ("conv1d_amax_kernel", "", 18, (0, 0)),
        ("conv1d_s8_kernel", "11,2,2", 128, (8, 8)),
        ("conv1d_mma_kernel", "0,11,2,2", 168, (0, 0))]
    assert {"conv1d_s8_kernel", "conv1d_amax_kernel"} <= set(cs.NO_SPILL)
    assert [k for k, _, _, sp in entries
            if k in cs.NO_SPILL and sp != (0, 0)] == ["conv1d_s8_kernel"]


def test_chip_smoke_prints_b_int8_rows_without_a_library_time(capsys):
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    calls = cs.main_path_calls(FlowHighConfig().vocoder, 1000, False, I8)
    inst = "conv1d_same.int8"
    rows = {inst: {}}
    for key in calls[inst]:
        byt, dots, other = cs.work(inst, key)
        rows[inst][key] = {
            "bytes_ms": byt / peaks[1] * 1e3,
            "ops_ms": (cs.dot_seconds(peaks, inst, dots, key)
                       + other / peaks[0]) * 1e3,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "unfused_chain_ms": None}
    tot = cs.path_totals({inst: calls[inst]}, rows)[inst]
    cs.print_conv_rows(inst, tot)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 * 3 * 3 + 1 and "cuDNN" not in "".join(out)
    assert out[-1].startswith(f"  {inst}: 90 launches")
