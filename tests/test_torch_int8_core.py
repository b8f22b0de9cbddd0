"""What surrounds the int8 instances of kernels D and E
(csrc/act_conv_core.cuh: act_conv_mma's I8 route, act_amax_kernel;
csrc/amp_unit.cu: amp_unit_s8_kernel) on the host, on the CPU: the
prepared int8 weights [K][Cout_p][Cin_p] under an integer GEMM tap by tap,
the Python mirrors of their shared memory at every full-width shape, their
tiles against ops/quant.py's windows, and the plain version of the window
scales' pre-pass against the amax the plain versions take."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flowhigh_tpu_torch.ops import conv as conv_mod
from flowhigh_tpu_torch.ops import fused_conv, quant
from flowhigh_tpu_torch.ops.fused_act import snake_activation1d_ordered

I8 = torch.int8
# (C, T) per stage of a 10 s clip; D runs at C = 768, 384, E at 192, 96, 48
FULL_WIDTH = [(768, 5000), (384, 20000), (192, 80000), (96, 240000),
              (48, 480000)]
RESBLOCKS = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def s8_route(win, w, dilation, bm, kc=32):
    """The I8 route's integer GEMM on the windows ``win`` [B, n, Cin, W]:
    each window quantised with its own scale (127 / amax, rounded half to
    even), the weights from ``conv_weight_layout(w, int8)`` [K, Cout_p,
    Cin_p] with their [Cout] scales, per block of ``bm`` output channels
    and per chunk of ``kc`` input channels (zeros past Cin), tap k the
    frame offset k d; sums in int64, then float(acc) * (s_x * s_w[co]).
    Returns [B, n, Cout, W - d (K - 1)]."""
    bsz, n, cin, width = win.shape
    cout, _, k = w.shape
    wl = conv_mod.conv_weight_layout(w, I8)
    assert wl.dtype == I8 and wl.shape[2] % kc == 0
    cout_p, cin_p = wl.shape[1], wl.shape[2]
    s_w = quant.int8_weights(w)[1]
    amax = torch.clamp(win.abs().amax(dim=(2, 3)), min=1e-30)
    c127 = torch.full_like(amax, 127.0)
    aq = torch.round(win * (c127 / amax)[..., None, None]).to(torch.int64)
    aq = F.pad(aq, (0, 0, 0, cin_p - cin))               # [B, n, Cin_p, W]
    n_out = width - dilation * (k - 1)
    acc = torch.zeros((bsz, n, -(-cout // bm) * bm, n_out),
                      dtype=torch.int64)
    for co0 in range(0, cout, bm):
        wb = torch.zeros((k, bm, cin_p), dtype=torch.int64)
        rows = max(0, min(bm, cout_p - co0))
        wb[:, :rows] = wl[:, co0:co0 + rows].to(torch.int64)
        for c0 in range(0, cin_p, kc):
            for tap in range(k):
                xk = aq[:, :, c0:c0 + kc,
                        tap * dilation:tap * dilation + n_out]
                acc[:, :, co0:co0 + bm] += torch.einsum(
                    "oc,bncl->bnol", wb[tap, :, c0:c0 + kc], xk)
    assert acc.abs().max() < 2 ** 31  # exact in the card's int32 sums
    fac = (amax / c127)[..., None] * s_w[None, None, :]     # [B, n, Cout]
    return acc[:, :, :cout].float() * fac[..., None]


@pytest.mark.parametrize("cin,cout,k,d,bm", [(45, 40, 7, 3, 64),
                                             (45, 40, 11, 1, 64),
                                             (96, 192, 3, 5, 96),
                                             (64, 48, 11, 5, 48)])
def test_prepared_int8_weights_give_the_plain_windows(cin, cout, k, d, bm):
    # Cin off the 32-channel chunk, Cout below the block and off the
    # 64-row padding: the integer GEMM over the prepared layout equals
    # quant.int8_conv_windows bit for bit
    gen = np.random.default_rng(cin + cout + k + d)
    w = _randn(gen, cout, cin, k, scale=(cin * k) ** -0.5)
    win = _randn(gen, 2, 3, cin, 40 + d * (k - 1))
    win[1, 2] = 0.0  # an all-zero window: amax clamps to 1e-30
    got = s8_route(win, w, d, bm)
    want = quant.int8_conv_windows(win, w, d)
    assert torch.equal(got, want)


def test_prepared_int8_weights_are_quantize_weights_values():
    gen = np.random.default_rng(3)
    w = _randn(gen, 70, 45, 7)
    wl = conv_mod.conv_weights(w, I8)
    assert conv_mod.conv_weights(w, I8) is wl  # once per weight tensor
    assert wl.shape == (7, 128, 64) and wl.dtype == I8
    wq, _ = quant.quantize_weights(w)
    assert torch.equal(wl[:, :70, :45].to(torch.int32), wq.permute(2, 0, 1))
    assert not wl[:, 70:].any() and not wl[:, :, 45:].any()
    w.add_(1.0)  # an in-place write prepares them anew
    assert not torch.equal(conv_mod.conv_weights(w, I8), wl)


# --- shared memory ---------------------------------------------------------

@pytest.mark.parametrize("k,d", RESBLOCKS)
@pytest.mark.parametrize("c,t", FULL_WIDTH)
def test_int8_smem_fits_every_full_width_shape(c, t, k, d):
    # D: two blocks an SM (its tensor-core tiles and clusters); E: one
    # block of its cluster (two at C = 192), two blocks an SM at C = 48
    pad = d * (k - 1) // 2
    bm, bn = fused_conv._pair_tile(c, I8)
    got = fused_conv.act_conv_smem_bytes(k, d, c, I8)
    aw = bn + 2 * pad
    assert got == (3 * bm * 32 + (2 if c % 128 == 0 else 1) * aw * 32
                   + 4 * (2 * 32 * (aw + 12) + 8 * 2 * (aw + 6) + 4 * 32))
    assert got <= fused_conv.SMEM_PER_BLOCK // 2
    if c <= 192:
        bm, bn = fused_conv._unit_tile(c, I8)
        assert (bm, bn) == (48 if c == 48 else 96, 256)
        aw = 256 + 2 * pad
        got = fused_conv.amp_unit_smem_bytes(k, d, c, I8)
        assert got == (4 * bm * 256 + -(-c // 32) * aw * 32 + 3 * bm * 32
                       + 4 * (2 * 8 * (aw + 12) + 8 * 2 * (aw + 6) + 32 + 8))
        assert got <= fused_conv.SMEM_PER_BLOCK // (2 if c == 48 else 1)


@pytest.mark.parametrize("k,d,c,fn,want", [
    # D at C = 768, k = 11, d = 5: 3 x 256 x 32 bytes of weights, two
    # buffers of 114 rows of 32 bytes, 2 x 32 x 126 raw floats, 8 x 2 x 120
    # signal floats, 128 parameters: two blocks an SM
    (11, 5, 768, "act_conv_smem_bytes", 72320),
    # D at C = 384, k = 3, d = 1: 128 x 128 tiles, 130 frames
    (3, 1, 384, "act_conv_smem_bytes", 66176),
    # E at C = 192, k = 11, d = 5: 96 x 256 floats of conv1 output, 6 x
    # 306 rows of the activation, 3 x 96 x 32 of weights, 2 x 8 x 318 raw
    # and 8 x 2 x 312 signal floats, 32 parameters, 8 maxima
    (11, 5, 192, "amp_unit_smem_bytes", 206752),
    # E at C = 48, k = 3, d = 1: one 48-channel block, two an SM
    (3, 1, 48, "amp_unit_smem_bytes", 104608)])
def test_int8_smem_pinned(k, d, c, fn, want):
    assert getattr(fused_conv, fn)(k, d, c, I8) == want


# --- tiles against the windows ---------------------------------------------

@pytest.mark.parametrize("c,t", FULL_WIDTH[:2] + [(64, 777), (48, 37)])
def test_d_int8_tiles_tile_the_windows(c, t):
    # every tile [t0, t0 + BN) lies in one window [256 w, 256 w + 256) and
    # the tiles of a window cover it exactly; the tile reads its window's
    # scale, so the activation it quantises (tile +- pad) lies in the
    # window's [256 w - pad, 256 w + 256 + pad)
    bn = fused_conv.act_conv_plan(3, 1, c, t, I8)
    assert bn == fused_conv._pair_tile(c, I8)[1]
    assert fused_conv.INT8_TILE % bn == 0
    n_win = -(-t // fused_conv.INT8_TILE)
    cover = {w: [] for w in range(n_win)}
    for t0 in range(0, t, bn):
        w = t0 // fused_conv.INT8_TILE
        assert t0 + bn <= (w + 1) * fused_conv.INT8_TILE
        cover[w].append(t0)
    for w, starts in cover.items():
        assert starts == list(range(w * fused_conv.INT8_TILE,
                                    min(t, (w + 1) * fused_conv.INT8_TILE),
                                    bn))


@pytest.mark.parametrize("k,d", RESBLOCKS)
@pytest.mark.parametrize("c", [192, 96, 48])
def test_e_int8_tile_is_the_plain_versions_window(c, k, d):
    # one cluster owns TT = 256 - 2 H outputs: conv1 over 256 samples from
    # t0 - H (act1 over 256 + 2 pad1), act2 over TT + 2 pad2 = 244, the
    # partition _amp_unit_int8 takes by default
    h = fused_conv.unit_halo(k)
    tt = fused_conv.amp_unit_plan(k, d, c, 10_000, I8)
    assert tt == fused_conv.INT8_TILE - 2 * h
    assert tt + 2 * ((k - 1) // 2) == fused_conv.INT8_TILE - 12
    bm, bn = fused_conv._unit_tile(c, I8)
    assert bn == tt + 2 * h and -(-c // bm) <= fused_conv.MAX_CLUSTER
    assert bm % 32 == 0 or -(-c // bm) == 1  # a block owns whole chunks


# --- the window scales' pre-pass -------------------------------------------

@pytest.mark.parametrize("c,t,k,d", [(45, 777, 7, 3), (16, 300, 11, 5),
                                     (48, 37, 3, 1), (20, 600, 3, 5)])
def test_pre_pass_plain_twin_gives_the_plain_versions_amax(c, t, k, d):
    gen = np.random.default_rng(c + t)
    x = _randn(gen, 2, c, t)
    x[1, :, 256:] = 0.0  # windows of zeros on the second row
    a, b = _randn(gen, c, scale=0.3), _randn(gen, c, scale=0.3)
    act = snake_activation1d_ordered(x, a, b, True)
    pad = d * (k - 1) // 2
    tile = fused_conv.INT8_TILE
    # kernel D: stride 256, lo -pad, width 256 + 2 pad (quant.conv1d_int8)
    n = -(-t // tile)
    part = fused_conv.act_amax_plain(x, a, b, True, stride=tile, lo=-pad,
                                     width=tile + 2 * pad, n_win=n)
    assert part.shape == (2, n, -(-c // fused_conv.AMAX_CH))
    want = quant.windows(act, -pad, tile + 2 * pad, tile, n).abs().amax(
        dim=(2, 3))
    assert torch.equal(part.amax(dim=-1), want)
    for g in range(part.shape[-1]):  # each partial: its 8 channels
        sl = slice(8 * g, 8 * g + 8)
        assert torch.equal(part[..., g], quant.windows(
            act[:, sl], -pad, tile + 2 * pad, tile, n).abs().amax(dim=(2, 3)))
    # kernel E's act1: stride TT, lo -H - pad1, width 256 + 2 pad1
    h = fused_conv.unit_halo(k)
    tt = tile - 2 * h
    n = -(-t // tt)
    part = fused_conv.act_amax_plain(x, a, b, True, stride=tt, lo=-h - pad,
                                     width=tile + 2 * pad, n_win=n)
    want = quant.windows(act, -h - pad, tile + 2 * pad, tt, n).abs().amax(
        dim=(2, 3))
    assert torch.equal(part.amax(dim=-1), want)


def test_pre_pass_scale_maps_each_windows_largest_value_to_127():
    # the kernels' quant_of(max of the partials): the largest |a| of a
    # window quantises to +-127, a window of zeros to zeros
    gen = np.random.default_rng(5)
    x = _randn(gen, 1, 24, 768)
    x[..., 480:] = 0.0  # the snake's reach of zeros: window 2 is all zero
    a, b = _randn(gen, 24, scale=0.3), _randn(gen, 24, scale=0.3)
    part = fused_conv.act_amax_plain(x, a, b, True, stride=256, lo=-1,
                                     width=258, n_win=3)
    amax = torch.clamp(part.amax(dim=-1), min=1e-30)
    win = quant.windows(snake_activation1d_ordered(x, a, b, True), -1, 258,
                        256, 3)
    c127 = torch.full_like(amax, 127.0)
    aq = torch.round(win * (c127 / amax)[..., None, None])
    assert aq[0, :2].abs().amax(dim=(1, 2)).tolist() == [127.0, 127.0]
    assert amax[0, 2] == 1e-30 and not aq[0, 2].any()


# --- chip_smoke.py's spill gate -------------------------------------------------

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__35024acf_13_act_conv1d_cu_b63f6b2115act_amax_kernelEPKfS1_S1_iPfiiiii' for 'sm_90a'
ptxas info    : Used 40 registers, used 0 barriers, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__35024acf_13_act_conv1d_cu_b63f6b2120act_conv1d_s8_kernelILi11ELi256ELi64ELi8ELb1EEEvPKfS2_S2_PKaS2_S2_S2_S2_S2_PfS2_iiiiiiiiif' for 'sm_90a'
ptxas info    : Used 128 registers, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0a56f1f1_11_amp_unit_cu_2fab9daf18amp_unit_s8_kernelILi3ELi96EEEvPKfS2_S2_S2_S2_PKaS2_S2_S4_S2_S2_S2_S2_PfS2_iiiiiiiif' for 'sm_90a'
ptxas info    : Used 114 registers, used 1 barriers, 0 bytes spill stores, 0 bytes spill loads
"""


def test_chip_smoke_gates_the_int8_instances_on_spills():
    # phase 0 parses every entry function, templated or not, and fails on
    # a spill in any tensor-core instance of D or E or the pre-pass
    from test_torch_convt_plan import _chip_smoke
    cs = _chip_smoke()
    entries = cs.ptxas_entries(PTXAS_LOG)
    assert [(k, a, r, sp) for k, a, r, sp in entries] == [
        ("act_amax_kernel", "", 40, (0, 0)),
        ("act_conv1d_s8_kernel", "11,256,64,8", 128, (8, 8)),
        ("amp_unit_s8_kernel", "3,96", 114, (0, 0))]
    assert {k for k, *_ in entries} <= set(cs.NO_SPILL)
    assert [k for k, _, _, sp in entries
            if k in cs.NO_SPILL and sp != (0, 0)] == ["act_conv1d_s8_kernel"]
