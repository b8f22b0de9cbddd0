"""Kernel F (csrc/flash_attn.cu) on the CPU: its arithmetic emulated, and
the fragment layout it stages in shared memory.

- ``emulate`` follows the kernel: key tiles of ``BN`` (read from the
  source) in order; both products on m16n8k8 tensor-core steps in 3xTF32,
  each operand split as the kernel's ``split_hi`` splits it (hi: 10
  mantissa bits, to nearest with ties away from zero, as ``tf32_split``;
  lo: the f32 remainder, truncated to TF32 as the tensor cores read it),
  each step's exact sum of its eight products and its accumulator rounded
  toward zero to f32, as the tensor cores round; S's k-steps (dims 16 c +
  4 t + 2 h and + 1) two at a time, the two of one 16-wide chunk of D, in a
  fresh accumulator joined by f32 adds; (P V) of a tile in a zeroed
  fragment over its k-steps of eight keys, joined as O alpha + (P V) by an
  FMA; the softmax in base 2 on logits scaled by scale * log2(e) in f32
  (``exp2`` here, the card's ``ex2.approx`` within 2 ulp of it), the running
  max per row and the running sum per lane (a lane sums the keys of one
  residue mod 4, in the kernel's order; the quad adds them at the end), a
  masked query seeded with the n_pad - N pad keys (max 0, sum n_pad - N).
- The emulation at the card test's ``FLASH`` shapes, both masks, scale 10,
  held to ``flash_attention_plain`` at atol and rtol 1e-4. The plain
  version is evaluated in float64: in float32 on the CPU it is itself up to
  1.4x that tolerance from its own float64 value at (2, 16, 1030), where
  the sharp logits amplify its rounding (the emulation there: 0.6x). A
  single TF32 product would not hold the tolerance.
- The emulation against the JAX package's ``_flash_attention`` (the Pallas
  kernel in interpret mode, under ``jax.jit``) at two shapes.
- The layout: S's columns are the keys that P's A fragment takes, the
  dims that one K load gives two k-steps, O's column map a bijection, every
  fragment load of K and V free of bank conflicts with the source's row
  paddings, and the shared memory of each instance within a block's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowhigh_tpu.models.transformer as JT
from flowhigh_tpu_torch.ops.flash_attn import flash_attention_plain, flash_pad
from test_torch_convt_plan import _chip_smoke, tf32
from test_torch_flash import interpret
from test_torch_kernels import FLASH

SRC = (Path(__file__).resolve().parents[1] / "flowhigh_tpu_torch" / "csrc"
       / "flash_attn.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


BN, WARPS, STAGES = _const("BN"), _const("WARPS"), _const("STAGES")
MT, BLOCKS = _const("MT"), _const("BLOCKS")
KPAD = int(re.search(r"int KLD = D \+ (\d+);", SRC).group(1))
VPAD = int(re.search(r"int VLD = D \+ (\d+);", SRC).group(1))
LOG2E = np.float32(float(re.search(r"float LOG2E = ([0-9.]+)f;", SRC).group(1)))
SCALE = 10.0  # the model's qk-norm scale, as the card test takes it


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(c, a, b):
    """One m16n8k8 step: c + a [.., 8] @ b [8, ..], the exact sum rounded
    toward zero."""
    return _rz(c.double() + a.double() @ b.double())


def _split_hi(v: torch.Tensor):
    """``split_hi``: hi = v rounded to TF32 (cvt.rna.tf32.f32), lo = the f32
    remainder v - hi (exact), of which the tensor cores take the top 19
    bits."""
    hi = tf32(v)
    lo = (v - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _mma3(c, a, b, terms=3):
    """The three TF32 products of mma_3xtf32_1688, the small ones first
    (``terms=1``: one TF32 product)."""
    (ah, al), (bh, bl) = _split_hi(a), _split_hi(b)
    if terms == 1:
        return _mma(c, tf32(a), tf32(b))
    return _mma(_mma(_mma(c, al, bh), ah, bl), ah, bh)


def _ksteps(d: int) -> list:
    """The dims of each k-step of S: k-step 2 c + h pairs 16 c + 4 t + 2 h
    (A's k = t) and + 1 (k = t + 4)."""
    return [[16 * c + 4 * t + 2 * h + e for e in (0, 1) for t in range(4)]
            for c in range(d // 16) for h in (0, 1)]


def emulate(q, k, v, mask, scale, terms=3):
    """Kernel F's arithmetic on the CPU; q, k, v [B, H, N, D] float32."""
    b, h, n, d = q.shape
    extra = flash_pad(n)
    seg = (torch.ones((b, n), dtype=torch.int32) if mask is None
           else mask.to(torch.int32))
    sq = seg[:, None, :, None]
    c2 = torch.tensor(np.float32(scale) * LOG2E)
    ninf = torch.tensor(-np.inf)
    pads = (sq == 0) & (extra > 0)
    m = torch.where(pads, 0.0, ninf).expand(b, h, n, 1).clone()
    lane = torch.zeros((b, h, n, 4))  # the quad's partial sums, t = 0..3
    lane[..., :1] = torch.where(pads, float(extra), 0.0)
    o = torch.zeros((b, h, n, d))
    steps = _ksteps(d)
    for k0 in range(0, n, BN):
        kt, vt = k[:, :, k0:k0 + BN], v[:, :, k0:k0 + BN]
        nk = kt.shape[2]
        kt, vt = (torch.nn.functional.pad(x, (0, 0, 0, BN - nk))
                  for x in (kt, vt))  # the ring's zero fill
        s = torch.zeros((b, h, n, BN))
        for pair in zip(steps[0::2], steps[1::2]):  # a chunk's two k-steps
            acc = torch.zeros_like(s)
            for idx in pair:
                acc = _mma3(acc, q[..., idx], kt[..., idx].transpose(-1, -2),
                            terms)
            s = s + acc
        ok = torch.zeros((b, 1, n, BN), dtype=torch.bool)
        ok[..., :nk] = seg[:, None, None, k0:k0 + nk] == sq
        s = torch.where(ok, s * c2, ninf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mn == ninf, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu)
        rs = torch.zeros_like(lane)  # lane t: keys 8 j + t, then 8 j + t + 4
        for j in range(BN // 8):
            for e in (0, 4):
                rs = rs + p[..., 8 * j + e:8 * j + e + 4]
        lane = (lane.double() * alpha.double() + rs.double()).float()
        pv = torch.zeros_like(o)
        for j in range(BN // 8):
            pv = _mma3(pv, p[..., 8 * j:8 * j + 8],
                       vt[..., 8 * j:8 * j + 8, :], terms)
        o = (o.double() * alpha.double() + pv.double()).float()
        m = mn
    total = (lane[..., 0:1] + lane[..., 1:2]) + (lane[..., 2:3] + lane[..., 3:4])
    return o * (1.0 / total)


def _inputs(b, h, n, valids, dh, heads=None):
    """The card test's kind of inputs, seeded; ``heads`` a subset of the
    heads (each head is independent of the others)."""
    rng = np.random.default_rng(n * 100 + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, dh)).astype(
        np.float32)) for _ in range(3))
    if heads is not None:
        q, k, v = (x[:, heads].contiguous() for x in (q, k, v))
    mask = torch.arange(n)[None, :] < torch.tensor(valids)[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("b,h,n,valids,dh", FLASH)
def test_emulation_holds_the_card_tolerance(b, h, n, valids, dh, masked):
    # the last head of the wide shapes
    q, k, v, mask = _inputs(b, h, n, valids, dh, [h - 1] if h > 2 else None)
    mask = mask if masked else None
    got = emulate(q, k, v, mask, SCALE)
    exact = flash_attention_plain(q.double(), k.double(), v.double(), mask,
                                  SCALE)
    torch.testing.assert_close(got.double(), exact, atol=1e-4, rtol=1e-4)


def _plain_fma_order(q, k, v, mask, scale):
    """``flash_attention_plain`` in float32 with each score summed as one
    FMA a dim in order, as the card's float32 GEMM sums it (the order the
    direct-FMA kernel F of PRs 3-12 shared with it)."""
    n = q.shape[2]
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, flash_pad(n)))
              for x in (k, v))
    seg = mask.to(torch.int32)
    seg_k = torch.nn.functional.pad(seg, (0, flash_pad(n)))
    s = torch.zeros(q.shape[:3] + (kp.shape[2],))
    for i in range(q.shape[-1]):
        s = (s.double() + q[..., i:i + 1].double()
             * kp[..., i].double()[:, :, None, :]).float()
    s = (s * scale).masked_fill(seg[:, None, :, None] != seg_k[:, None, None, :],
                                float("-inf"))
    return torch.matmul(s.softmax(dim=-1), vp)


def test_the_float32_plain_version_is_not_a_1e4_reference_at_d64():
    """Why the card test holds F to the plain version in float64: at its
    inputs for (1, 16, 1000, 950 valid, D = 64), head 11, row 137 (each head
    is independent; the others are within), the float32 plain version
    summed as the card sums it is itself beyond atol / rtol 1e-4 from its
    float64 value (sharp logits: 10 q.k with |q.k| up to ~30), which the
    direct-FMA F of PRs 3-12 met only by sharing that rounding; the 3xTF32
    kernel, emulated, is within it. (The same emulation against the card's
    float32 plain version gives the card's max abs 1.74e-4.)"""
    gen = np.random.default_rng(0)  # tests/test_torch_kernels.py's inputs
    q, k, v = (torch.from_numpy(gen.standard_normal((1, 16, 1000, 64)).astype(
        np.float32))[:, 11:12] for _ in range(3))
    mask = torch.arange(1000)[None, :] < 950
    exact = flash_attention_plain(q.double(), k.double(), v.double(), mask,
                                  SCALE)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(_plain_fma_order(q, k, v, mask, SCALE).double(),
                                   exact, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(emulate(q, k, v, mask, SCALE).double(), exact,
                               atol=1e-4, rtol=1e-4)


def test_one_tf32_product_would_not_hold_it():
    q, k, v, mask = _inputs(1, 16, 1000, (950,), 64, [15])
    exact = flash_attention_plain(q.double(), k.double(), v.double(), mask,
                                  SCALE)
    err = float((emulate(q, k, v, mask, SCALE, terms=1).double()
                 - exact).abs().max())
    assert err > 1e-3, err


@pytest.mark.parametrize("b,h,n,valids,dh", [FLASH[0], FLASH[1]])
def test_emulation_matches_the_jax_function(b, h, n, valids, dh):
    # one block each (blk >= n): the JAX package's bound there is atol 1e-4
    q, k, v, mask = _inputs(b, h, n, valids, dh)
    fn = jax.jit(lambda q_, k_, v_, m_: JT._flash_attention(q_, k_, v_, m_,
                                                            SCALE))
    with interpret():
        want = np.asarray(fn(*(jnp.asarray(x.numpy()) for x in (q, k, v, mask))))
    np.testing.assert_allclose(emulate(q, k, v, mask, SCALE).numpy(), want,
                               atol=1e-4, rtol=1e-4)


# --- the fragment layout ------------------------------------------------------------

def _banks_free(addrs, width):
    """Each phase of a shared load of ``width`` words a lane (32 lanes,
    128 bytes a phase) touches each of the 32 banks at most once."""
    per = 32 // width
    for ph in range(0, 32, per):
        banks = [(a + w) % 32 for a in addrs[ph:ph + per] for w in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("d", [16, 32, 64])
def test_fragment_layout(d):
    kld, vld = d + KPAD, d + VPAD
    j_tiles = d // 8
    jg = min(j_tiles, 4)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    krow = [(g >> 1) + 4 * (g & 1) for g in range(8)]
    # S column c of an n-tile holds key krow[c]: columns 2t, 2t + 1 (the
    # accumulator's) are keys t and t + 4 (A's k = t, t + 4 of P V)
    assert [krow[2 * t] for t in range(4)] == [0, 1, 2, 3]
    assert [krow[2 * t + 1] for t in range(4)] == [4, 5, 6, 7]
    # S's k-steps cover D once, and one 16-byte K load serves two of them
    steps = _ksteps(d)
    assert sorted(x for s in steps for x in s) == list(range(d))
    for c in range(d // 16):
        for t in range(4):
            assert [steps[2 * c][t], steps[2 * c][t + 4], steps[2 * c + 1][t],
                    steps[2 * c + 1][t + 4]] == [16 * c + 4 * t + e
                                                 for e in range(4)]
    # O's n-tile j, column c is dim 8 JG (j / JG) + JG c + j % JG: a bijection
    dims = {8 * jg * (j // jg) + jg * c + j % jg for j in range(j_tiles)
            for c in range(8)}
    assert dims == set(range(d))
    # no bank conflicts: K (16-byte loads), V (JG words a load, rows t and
    # t + 4)
    for c in range(d // 16):
        assert _banks_free([krow[g] * kld + 16 * c + 4 * t for g, t in lanes], 4)
    for row in (0, 4):
        for gr in range(j_tiles // jg):
            assert _banks_free([(row + t) * vld + 8 * jg * gr + jg * g
                                for g, t in lanes], jg)
    # the ring and Q's split fragments within a block's shared memory, and
    # BLOCKS blocks within an SM's (228 KB, 1 KB of it reserved a block);
    # 16-byte aligned rows
    stage = 4 * (BN * kld + BN * vld + BN)
    smem = STAGES * stage + 4 * WARPS * MT * j_tiles * 2 * 32 * 4
    assert smem <= 232448 and BLOCKS * (smem + 1024) <= 233472
    assert kld % 4 == 0 and vld % 4 == 0
    assert stage % 16 == 0 and (4 * BN * kld) % 16 == 0


def test_padding_keys_follow_the_jax_function():
    # a masked query's seed: n_pad - N pad keys of logit 0 and value 0;
    # without it the masked rows would move by more than 1e-2 (logits near
    # 0: q scaled down)
    n, valid = 200, 150
    q, k, v, mask = _inputs(1, 2, n, (valid,), 16)
    q = q * 0.05
    got = emulate(q, k, v, mask, SCALE).double()
    exact = flash_attention_plain(q.double(), k.double(), v.double(), mask,
                                  SCALE)
    torch.testing.assert_close(got, exact, atol=1e-4, rtol=1e-4)
    assert flash_pad(n) == 56
    sim = torch.matmul(q.double(), k.double().transpose(-1, -2)) * SCALE
    same = mask[:, None, :, None] == mask[:, None, None, :]
    unseeded = torch.matmul(sim.masked_fill(~same, -np.inf).softmax(-1),
                            v.double())
    assert (got - unseeded)[:, :, valid:].abs().max() > 1e-2


def test_chip_smoke_bounds_kernel_f_by_3xtf32():
    # the long-form shape on an H100 SXM: 3.69e12 dot operations a launch,
    # three TF32 products each at 495 TFLOP/s, and 5 softmax operations a
    # score at 67 TFLOP/s; PR 3's bound counted the dots as f32 FMAs
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    byt, dots, other = cs.flash_work((30000,), 30000)
    assert dots == 4 * 64 * 16 * 30000 ** 2 and other == 5 * 16 * 30000 ** 2
    tc = (cs.dot_seconds(peaks, cs.FLASH, dots) + other / peaks[0]) * 1e3
    assert round(2 * tc, 2) == 46.83 and round(2 * dots / peaks[0] * 1e3, 2) == 110.04
    assert byt / peaks[1] * 1e3 < 0.01 * tc  # far from the bytes
    assert "flash_attn_kernel" in cs.NO_SPILL and cs.DOT_UNITS["flash_attn"] == (3, 4)
