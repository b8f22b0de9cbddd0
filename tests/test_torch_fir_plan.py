"""Probe kernel H (csrc/probe_fir.cu) on the CPU: its arithmetic emulated,
and the shared-memory layouts it stages.

- ``emulate`` follows the kernel's order of operations. f32: both products
  on m16n8k8 tensor-core steps in 3xTF32, each operand split as
  ``split_hi`` splits it (hi: 10 mantissa bits, to nearest with ties away
  from zero; lo: the f32 remainder, truncated to TF32 as the tensor cores
  read it), each step's exact sum of its eight products and its
  accumulator rounded toward zero to f32, as the tensor cores round; each
  16-wide k-chunk (two k-steps, six products, the small ones first) in a
  fresh accumulator joined to the sum by an f32 add; GEMM1's k-chunks tap
  by tap (q) and along L within a tap, GEMM2's chunk of NC intermediate
  columns by chunk, tap by tap within it. bf16: xe and s2 rounded to bf16
  (nearest even), the products exact, one wgmma k16 step (16 products) at
  a time into one f32 accumulator over the whole of K, rounded toward zero
  at each step; GEMM1 k-slab by k-slab of 64 with the three taps' slabs
  side by side in a stage, GEMM2 tap by tap within a chunk. The snake is
  the plain version's (the card's sine is held to 1.34e-7 in
  tests/test_torch_snake_plan.py).
- The emulation against ``mxu_fir_plain`` at the card's tolerances (f32:
  atol = rtol = 1e-4 on values divided by max |plain|; bf16: relative L2
  1e-3 and max abs 1e-2 x max(1, max |plain|)) and against the JAX
  script's ``mxu_fir`` (lifted as tests/test_torch_probes.py lifts it, the
  Pallas kernel in TPU interpret mode under ``jax.jit``).
- The layouts: each instance's shared memory within a block's 227 KB; the
  f32 fragment loads and stores free of bank conflicts with the source's
  row paddings; the bf16 operands as the wgmma descriptors address them
  (xe and s2 K-major without swizzle, a tap a 16-byte step of the start
  address; weight slices K-major with the 128-byte swizzle) read back the
  right elements, and their staging writes are free of bank conflicts;
  chip_smoke.py's bounds and spill gate for H.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flowhigh_tpu_torch.ops.probes import mxu_fir_plain, snake_probe
from flowhigh_tpu_torch.ops.quant import round_bf16
from test_torch_convt_plan import _chip_smoke, tf32
from test_torch_probes import MXU_FIR, _bf16, _interpret

import jax.numpy as jnp

SRC = (Path(__file__).resolve().parents[1] / "flowhigh_tpu_torch" / "csrc"
       / "probe_fir.cu").read_text()
F32_SRC = SRC[SRC.index("namespace f32k {"):SRC.index("}  // namespace f32k")]
BF16_SRC = SRC[SRC.index("namespace bf16k {"):
               SRC.index("}  // namespace bf16k")]
SMEM_MAX = 232448  # 227 KB, a block's shared memory on an H100


def _const(name: str, src: str = SRC) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


NC, THREADS = _const("NC"), _const("THREADS")
F32 = {k: _const(k, F32_SRC) for k in ("M1", "KS1", "KS2", "STAGES", "BARS")}
BF = {k: _const(k, BF16_SRC) for k in ("M1", "STAGES", "SLICE", "ALIGN",
                                       "BARS")}
F32_PAD = {name: int(re.search(rf"{pat} \+ (\d+)", F32_SRC).group(1))
           for name, pat in (("x", r"int ldx\(int L\) \{ return L"),
                             ("s", "LDS = NC"))}
LANES = list(range(64, 385, 64))


# --- the arithmetic -----------------------------------------------------------------

def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _step(c, a, b):
    """One tensor-core step: c + a [.., k] @ b [k, ..], the exact sum
    rounded toward zero."""
    return _rz(c.double() + a.double() @ b.double())


def _split_hi(v: torch.Tensor):
    """``split_hi``: hi = v rounded to TF32, lo = the f32 remainder of which
    the tensor cores take the top 19 bits."""
    hi = tf32(v)
    lo = (v - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _chunk_3xtf32(a, b):
    """A 16-wide k-chunk in a fresh accumulator: per k-step of 8, the
    three TF32 products, small ones first."""
    d = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for h in (0, 1):
        (ah, al), (bh, bl) = (_split_hi(v) for v in (a[..., 8 * h:8 * h + 8],
                                                     b[8 * h:8 * h + 8]))
        d = _step(_step(_step(d, al, bh), ah, bl), ah, bh)
    return d


def _join(acc, d):
    return (acc.double() + d.double()).float()  # an f32 add, to nearest


def _xe(x):
    s = x.shape[1]
    return torch.cat([x[:, 6:8], x, x[:, s - 8:s - 6]], dim=1)  # rows -2..S+1


def _snake(s2, ab2, do_snake):
    return snake_probe(s2, ab2[0], ab2[1]) if do_snake else s2


def emulate_f32(x, up, dn, ab2, do_snake=True):
    s, lanes = x.shape[1], x.shape[2]
    xe = _xe(x)
    s2 = torch.zeros(x.shape[0], s + 2, 2 * lanes)
    for q in range(3):  # GEMM1: tap by tap, along L in 16-wide chunks
        for k in range(0, lanes, 16):
            s2 = _join(s2, _chunk_3xtf32(xe[:, q:q + s + 2, k:k + 16],
                                         up[q, k:k + 16]))
    s2 = _snake(s2, ab2, do_snake)
    out = torch.zeros_like(x)
    for c in range(0, 2 * lanes, NC):  # GEMM2: chunk by chunk, tap by tap
        for q in range(3):
            for k in range(c, c + NC, 16):
                out = _join(out, _chunk_3xtf32(s2[:, q:q + s, k:k + 16],
                                               dn[q, k:k + 16]))
    return out


def emulate_bf16(x, up, dn, ab2, do_snake=True):
    s, lanes = x.shape[1], x.shape[2]
    xe = round_bf16(_xe(x))
    upf, dnf = up.float(), dn.float()
    s2 = torch.zeros(x.shape[0], s + 2, 2 * lanes)
    for j in range(0, lanes, 64):  # GEMM1: k-slab by k-slab, taps inside
        for q in range(3):
            for k in range(j, j + 64, 16):
                s2 = _step(s2, xe[:, q:q + s + 2, k:k + 16], upf[q, k:k + 16])
    s2 = round_bf16(_snake(s2, ab2, do_snake))
    out = torch.zeros_like(x)
    for c in range(0, 2 * lanes, NC):  # GEMM2: chunk, tap, k16 step
        for q in range(3):
            for k in range(c, c + NC, 16):
                out = _step(out, s2[:, q:q + s, k:k + 16], dnf[q, k:k + 16])
    return out


def _inputs(b, s, lanes, dtype, seed=0):
    """tests/test_torch_kernels.py's kind of inputs: x * 0.3, unit-normal
    FIR matrices, exp'd snake parameters."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x = t(b, s, lanes, scale=0.3)
    up, dn = t(3, lanes, 2 * lanes).to(dtype), t(3, 2 * lanes, lanes).to(dtype)
    ab2 = torch.exp(t(2, 2 * lanes, scale=0.1))
    return x, up, dn, ab2


def _hold(got, want, dtype):
    """The card's tolerances (tests/test_torch_kernels.py)."""
    got, want = got.double(), want.double()
    if dtype == torch.float32:
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, atol=1e-4,
                                   rtol=1e-4)
    else:
        d = got - want
        assert d.norm() / want.norm() <= 1e-3
        assert d.abs().max() <= 1e-2 * max(1.0, float(want.abs().max()))


EMULATE = {torch.float32: emulate_f32, torch.bfloat16: emulate_bf16}


@pytest.mark.parametrize("lanes,s", [(64, 200), (128, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("do_snake", [True, False])
def test_emulation_holds_the_card_tolerance(lanes, s, dtype, do_snake):
    x, up, dn, ab2 = _inputs(2, s, lanes, dtype)
    want = mxu_fir_plain(x, up, dn, ab2, do_snake=do_snake)
    got = EMULATE[dtype](x, up, dn, ab2, do_snake)
    assert got.shape == x.shape and torch.isfinite(got).all()
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_matches_the_jax_function(dtype):
    # the JAX script's width at p = 4, C = 16 (L = 64), S = 256: one tile
    x, up, dn, ab2 = _inputs(2, 256, 64, dtype, seed=1)
    bf16 = dtype == torch.bfloat16
    ju, jd = ((_bf16(up.float().numpy()), _bf16(dn.float().numpy())) if bf16
              else (jnp.asarray(up.numpy()), jnp.asarray(dn.numpy())))
    want = torch.from_numpy(_interpret(
        lambda a, u, d, e: MXU_FIR(a, u, d, e, do_snake=True),
        jnp.asarray(x.numpy()), ju, jd, jnp.asarray(ab2.numpy())))
    _hold(EMULATE[dtype](x, up, dn, ab2), want, dtype)


def test_the_f32_instance_needs_three_tf32_products():
    # one TF32 product per f32 one (hi x hi) misses the card's 1e-4
    x, up, dn, ab2 = _inputs(2, 200, 128, torch.float32)
    want = mxu_fir_plain(x, up, dn, ab2).double()
    s = x.shape[1]
    xe = _xe(x)
    s2 = sum(tf32(xe[:, q:q + s + 2]).double() @ tf32(up[q]).double()
             for q in range(3))
    s2 = snake_probe(s2.float(), ab2[0], ab2[1])
    one = sum(tf32(s2[:, q:q + s]).double() @ tf32(dn[q]).double()
              for q in range(3))
    err = float(((one - want).abs() / want.abs().max()).max())
    assert err > 1e-4, err
    torch.testing.assert_close(emulate_f32(x, up, dn, ab2).double() / want.abs().max(),
                               want / want.abs().max(), atol=1e-4, rtol=1e-4)


# --- the f32 instance's layout ---------------------------------------------------------

def _f32_smem(lanes):
    lx, lds = lanes + F32_PAD["x"], NC + F32_PAD["s"]
    xr = F32["M1"] + 2
    stage = max(F32["KS1"] * NC, F32["KS2"] * lanes)
    return F32["BARS"] + 4 * (xr * lx + xr * lds + F32["STAGES"] * stage)


def _free(addrs, words):
    """A shared access of ``words`` 4-byte words a lane, 32 lanes: each
    phase (32 banks, 128 bytes) touches each bank at most once."""
    per = 32 // words
    for ph in range(0, 32, per):
        banks = [(a + w) % 32 for a in addrs[ph:ph + per] for w in range(words)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("lanes", LANES)
def test_f32_layout(lanes):
    assert _f32_smem(lanes) <= SMEM_MAX
    gt = [(lane >> 2, lane & 3) for lane in range(32)]
    # A fragments: one float2 a row, (row g, k 2t) and (g + 8, 2t), from xe
    # rows (L + pad) and s2 rows (NC + pad)
    for ld in (lanes + F32_PAD["x"], NC + F32_PAD["s"]):
        for r in (0, 8):
            assert _free([(g + r) * ld + 2 * t for g, t in gt], 2)
    # B fragments: one 16-byte load a lane, 32 lanes side by side (the
    # slices' fragment order)
    assert _free([4 * lane for lane in range(32)], 4)
    # the snake's float2 stores into s2 (rows g, g + 8, cols 2t)
    assert _free([g * (NC + F32_PAD["s"]) + 2 * t for g, t in gt], 2)
    # 16-byte cp.async rows of xe stay aligned, and s2's float2 stores
    assert (lanes + F32_PAD["x"]) % 4 == 0 and (NC + F32_PAD["s"]) % 2 == 0


def _fragment(r16, col):
    """Where fragment order keeps row r16 (< 16) of a k-chunk and column
    col of a slice: (n-tile, lane, float): lane 4 g + t holds rows 2t,
    2t + 1, 2t + 8, 2t + 9 of column 8 jn + g."""
    t, e = (r16 % 8) // 2, r16 % 2 + 2 * (r16 // 8)
    return col // 8, 4 * (col % 8) + t, e


@pytest.mark.parametrize("lanes", [64, 192, 384])
def test_f32_image_holds_the_slices_the_kernel_reads(lanes):
    # fir_pack_f32_kernel's placement, mirrored: every float of up and dn
    # lands once in 12 L^2, in the slice, k-chunk, n-tile and lane whose
    # fragment the kernel loads it as (GEMM1 slice (c, q, k-slab): up[q][k]
    # [c NC + col]; GEMM2 slice (c, q, k-slab): dn[q][c NC + k][col])
    ks1, ks2 = F32["KS1"], F32["KS2"]
    n1, kb2n = 3 * (lanes // ks1), NC // ks2
    b1, b2 = ks1 * NC, ks2 * lanes
    chunk = n1 * b1 + 3 * kb2n * b2
    assert (b1 * 4) % 16 == 0 and (b2 * 4) % 16 == 0  # bulk-copy sizes
    seen = np.zeros((2 * lanes // NC) * chunk, dtype=np.int32)
    assert seen.size == 12 * lanes ** 2
    q, k, n = np.meshgrid(np.arange(3), np.arange(lanes), np.arange(2 * lanes),
                          indexing="ij")
    c, j, kr = n // NC, q * (lanes // ks1) + k // ks1, k % ks1
    jn, lane, e = _fragment(kr % 16, n % NC)
    off = c * chunk + j * b1 + ((kr // 16 * (NC // 8) + jn) * 32 + lane) * 4 + e
    np.add.at(seen, off, 1)
    q, kk, n = np.meshgrid(np.arange(3), np.arange(2 * lanes), np.arange(lanes),
                           indexing="ij")
    c, j2 = kk // NC, q * kb2n + (kk % NC) // ks2
    jn, lane, e = _fragment(kk % 16, n)
    off = c * chunk + n1 * b1 + j2 * b2 + (jn * 32 + lane) * 4 + e
    np.add.at(seen, off, 1)
    assert (seen == 1).all()


# --- the bf16 instance's layout ---------------------------------------------------------

XR_BF = BF["M1"] + 2


def _bf16_smem(lanes):
    return BF["BARS"] + BF["ALIGN"] + BF["STAGES"] * BF["SLICE"] \
        + lanes // 8 * XR_BF * 16 + NC // 8 * BF["M1"] * 16 + 32


def _sw128(n, ch):
    """The kernel's ``sw128``: byte offset of 16-byte chunk ch of row n."""
    return (n >> 3) * 1024 + (n & 7) * 128 + ((ch ^ (n & 7)) << 4)


def _read_swizzled(start, n, k):
    """Byte offset at which wgmma reads element (n, k) (k < 16) of a K-major
    operand with the 128-byte swizzle whose descriptor starts at ``start``
    (a 1,024-byte aligned atom plus 32 bytes a k16 step): the address's
    16-byte chunk bits [4, 7) XOR its row bits [7, 10)."""
    lin = start + (n // 8) * 1024 + (n % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
    return (lin & ~0x70) | ((((lin >> 4) & 7) ^ ((lin >> 7) & 7)) << 4)


def _read_plain(start, m, k, lbo, sbo=128):
    """Byte offset of element (m, k) of a K-major operand without swizzle:
    8-row core matrices of 16-byte rows, SBO apart along M, LBO along K."""
    return start + (m // 8) * sbo + (m % 8) * 16 + (k // 8) * lbo + (k % 8) * 2


@pytest.mark.parametrize("lanes", LANES)
def test_bf16_layout(lanes):
    half = lanes // 2
    assert _bf16_smem(lanes) <= SMEM_MAX
    # a slice: GEMM1's three taps of NH rows x 64 k, GEMM2's L / 2 rows
    assert 3 * (NC // 2) * 128 <= BF["SLICE"] and half * 128 <= BF["SLICE"]
    # descriptor fields: start >> 4 and LBO >> 4 within 14 bits
    assert _bf16_smem(lanes) >> 4 < 1 << 14 and XR_BF * 16 >> 4 < 1 << 14
    rng = np.random.default_rng(lanes)
    # the weight slice as issue() stages it, read back through descriptors
    w = rng.integers(0, 1 << 16, size=(half, 64))
    img = np.zeros(BF["SLICE"] // 2, dtype=np.int64)
    offs = {_sw128(n, ch) for n in range(half) for ch in range(8)}
    assert len(offs) == 8 * half  # a bijection onto the slice's chunks
    for n in range(half):
        for ch in range(8):
            img[_sw128(n, ch) // 2 + np.arange(8)] = w[n, 8 * ch:8 * ch + 8]
    for kk in range(4):
        got = np.array([[img[_read_swizzled(32 * kk, n, k) // 2]
                         for k in range(16)] for n in range(half)])
        np.testing.assert_array_equal(got, w[:, 16 * kk:16 * kk + 16])
    # xe as the kernel stores it, [L / 8][XR][8]; a tap q is the start
    # address plus 16 q bytes; warpgroup wg's rows start at 64 wg
    xe = rng.integers(0, 1 << 16, size=(XR_BF, lanes))
    xs = np.zeros(lanes // 8 * XR_BF * 8, dtype=np.int64)
    for kc in range(lanes // 8):
        xs[kc * XR_BF * 8:(kc + 1) * XR_BF * 8] = xe[:, 8 * kc:8 * kc + 8] \
            .reshape(-1)
    for wg in (0, 1):
        for q in range(3):
            for k0 in (0, lanes - 16):
                start = (k0 // 8) * XR_BF * 16 + (64 * wg + q) * 16
                got = np.array([[xs[_read_plain(start, m, k, XR_BF * 16) // 2]
                                 for k in range(16)] for m in range(64)])
                np.testing.assert_array_equal(
                    got, xe[64 * wg + q:64 * wg + q + 64, k0:k0 + 16])
    # bank groups: a wgmma core matrix (8 rows of one 16-byte chunk) and a
    # row's 8 cp.async chunks (8 lanes a phase) each touch all 8 distinct
    # 16-byte groups of the 32 banks
    for n0 in range(0, half, 8):
        for ch in range(8):
            assert len({(_sw128(n0 + r, ch) >> 4) % 8 for r in range(8)}) == 8
            assert len({(_sw128(n0 + ch, c) >> 4) % 8 for c in range(8)}) == 8
    # xe staging (16 bytes to consecutive rows a lane) and the snake's
    # 4-byte stores into s2 (rows g, cols 2t) are free of bank conflicts
    assert _free([4 * j for j in range(32)], 4)
    assert _free([4 * g + t for g, t in
                  [(lane >> 2, lane & 3) for lane in range(32)]], 1)


def _slice_offset(lanes, h, c, j):
    """The kernel's ``issue``: where slice j of chunk c of block h's image
    starts, and its bytes."""
    nh, half = NC // 2, lanes // 2
    b1, b2, n1, n2 = 3 * nh * 128, half * 128, lanes // 64, 3 * (NC // 64)
    chunk = n1 * b1 + n2 * b2
    image = (2 * lanes // NC) * chunk
    off = h * image + c * chunk + (j * b1 if j < n1 else n1 * b1
                                   + (j - n1) * b2)
    return off, (b1 if j < n1 else b2), image


@pytest.mark.parametrize("lanes", LANES)
def test_bf16_images_hold_the_slices_the_kernel_reads(lanes):
    # fir_pack_kernel's placement of up [3][L][2L] and dn [3][2L][L],
    # mirrored: every element lands once, inside 12 L^2 bf16, where the
    # kernel's wgmma reads it: GEMM1 slice (c, j) of block h, tap q, row n,
    # k: up[q][64 j + k][c NC + h NC / 2 + n]; GEMM2 slice (c, q, kb), row
    # n, k: dn[q][c NC + 64 kb + k][h L / 2 + n]
    nh, half = NC // 2, lanes // 2
    _, _, image = _slice_offset(lanes, 0, 0, 0)
    assert 2 * image == 2 * 12 * lanes ** 2  # bytes of 12 L^2 bf16
    seen = np.zeros(image, dtype=np.int32)  # both halves, in 2-byte units
    q, k, n = np.meshgrid(np.arange(3), np.arange(lanes), np.arange(2 * lanes),
                          indexing="ij")
    c, h, row = n // NC, (n % NC) // nh, n % nh
    j, ch, e = k // 64, (k % 64) // 8, k % 8
    off = np.vectorize(lambda h_, c_, j_: _slice_offset(lanes, h_, c_, j_)[0])(
        h, c, j) + q * (nh * 128) + _sw128(row, ch) + 2 * e
    np.add.at(seen, off // 2, 1)
    # the kernel reads tap q's slab at q NH 128 + the 128B-swizzled (row, k)
    kk = k % 64
    back = np.vectorize(lambda h_, c_, j_: _slice_offset(lanes, h_, c_, j_)[0])(
        h, c, j) + q * (nh * 128) + np.vectorize(_read_swizzled)(
            32 * (kk // 16), row, kk % 16)
    np.testing.assert_array_equal(back, off)
    q, kk, n = np.meshgrid(np.arange(3), np.arange(2 * lanes), np.arange(lanes),
                           indexing="ij")
    c, kb, h, row = kk // NC, (kk % NC) // 64, n // half, n % half
    jj = lanes // 64 + q * (NC // 64) + kb
    ch, e = (kk % 64) // 8, kk % 8
    off = np.vectorize(lambda h_, c_, j_: _slice_offset(lanes, h_, c_, j_)[0])(
        h, c, jj) + _sw128(row, ch) + 2 * e
    np.add.at(seen, off // 2, 1)
    assert (seen == 1).all()


def test_chip_smoke_bounds_kernel_h():
    # the probe script's three cases with p > 1 (S = 60,000, 60,000, 40,000;
    # L = 384) on an H100 SXM: 24 S L^2 operations, f32 as 3xTF32 at 495
    # TFLOP/s (3.43 ms), beside the f32 FMA peak (8.45) and bf16 (0.57)
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    dots = sum(24.0 * s * 384 ** 2 for s in (60000, 60000, 40000))
    assert round(cs.dot_seconds(peaks, "mxu_fir", dots) * 1e3, 2) == 3.43
    assert round(cs.dot_seconds(peaks, "mxu_fir.dots", dots) * 1e3, 2) == 3.43
    assert round(cs.dot_seconds(peaks, "mxu_fir.bf16", dots) * 1e3, 2) == 0.57
    assert round(dots / peaks[0] * 1e3, 2) == 8.45
    bench = cs._load_probe_script()
    # the probe script's rows at S = 4,096, L = 64 (operations bound them)
    inp = bench.case_inputs(np.random.default_rng(0), 4096, 16, 4, "cpu")
    rows = bench.case_rows(inp, 4096, 16, 4, peaks)
    want = cs.dot_seconds(peaks, "mxu_fir", 24.0 * 4096 * 64 ** 2) * 1e3
    assert rows["mxu_fir f32"][2] == pytest.approx(want)
    assert rows["mxu_fir f32 dots_only"][2] == pytest.approx(want)
    assert rows["mxu_fir f32"][3] == "operations"
    assert {"fir_tf32_kernel", "fir_wgmma_kernel", "fir_pack_f32_kernel",
            "fir_pack_kernel"} <= set(cs.NO_SPILL)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__653df74e_12_probe_fir_cu_846cc07b5bf16k16fir_wgmma_kernelILb1ELi192EEEvPKfPK13__nv_bfloat16S6_S3_Pfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 202 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__653df74e_12_probe_fir_cu_846cc07b5bf16k15fir_pack_kernelEPK13__nv_bfloat16S3_Phi' for 'sm_90a'
ptxas info    : Used 32 registers, used 1 barriers, 2176 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__653df74e_12_probe_fir_cu_846cc07b4f32k15fir_tf32_kernelILb1EEEvPKfS3_S3_S3_Pfii' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_chip_smoke_reads_kernel_names_inside_namespaces():
    # H's kernels sit in namespaces f32k and bf16k: the kernel is the last
    # length-prefixed name of the mangled one (the log: a spill made up for
    # the f32 instance)
    cs = _chip_smoke()
    entries = cs.ptxas_entries(PTXAS_LOG)
    assert entries == [("fir_wgmma_kernel", "192", 202, (0, 0)),
                       ("fir_pack_kernel", "", 32, (0, 0)),
                       ("fir_tf32_kernel", "", 255, (8, 8))]
    assert [k for k, _, _, sp in entries
            if k in cs.NO_SPILL and sp != (0, 0)] == ["fir_tf32_kernel"]
