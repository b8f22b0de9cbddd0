"""Kernel A (csrc/snake_aa.cu) on the CPU: its strip-and-halo structure and
its sine, emulated, and the edge of the function it computes against the
JAX package.

- The kernel's indexing emulated in float64 (one-dimensional grid over
  (row, tile), strips of R outputs a thread, 16-byte windows of x, own
  2x-rate samples, the left and right halos from neighbouring lanes, the
  warp's outer halos from lanes 0..9, unclamped interior tiles, clamped
  edge tiles with the down stage's edge samples, guarded stores) against
  ``snake_activation1d_plain``. R and the warps a block are read from the
  source, so the emulation follows the kernel.
- The sine of ``csrc/snake.cuh`` emulated in float32 step for step (its
  constants read from the source) against ``sin`` in float64 over
  |t| <= 2^15, at the bound the source states.
- The port's function against the JAX package's unfused composition
  (``flowhigh_tpu/models/bigvgan.py``, ``Activation1d`` with
  ``fused=False``) and its fused Pallas kernel in interpret mode under
  ``jax.jit``: the composition everywhere; the fused kernel everywhere but
  the last samples at the lengths where its ``_pick_tile`` finds no tile
  (it pads x and fixes the padded length's edge there).
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu.models import bigvgan as jax_bigvgan
from flowhigh_tpu.ops.fused_act import _pick_tile, fused_snake_activation1d
from flowhigh_tpu_torch import ops
from flowhigh_tpu_torch.models.bigvgan import kaiser_sinc_filter1d

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

CSRC = Path(__file__).resolve().parents[1] / "flowhigh_tpu_torch" / "csrc"
SRC = (CSRC / "snake_aa.cu").read_text()
R = int(re.search(r"constexpr int R = (\d+);", SRC).group(1))
WARPS = int(re.search(r"constexpr int WARPS = (\d+);", SRC).group(1))
TILE = 32 * WARPS * R
SINE_SRC = (CSRC / "snake.cuh").read_text()
SINE_BOUND_TEXT = "1.34e-7"  # the worst-case absolute error snake.cuh states
SINE_BOUND = float(SINE_BOUND_TEXT)
ROW_CHUNK = 2048      # rows emulated at once (memory)


def _consts() -> dict:
    """The sine's float32 constants, read from snake.cuh's hex literals."""
    return {name: np.float32(float.fromhex(v)) for name, v in re.findall(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-Fp.+-]+)f;", SINE_SRC)}


# --- the strip-and-halo structure -----------------------------------------------

def _act(alpha, beta, logscale):
    """The snake per row of the emulation, in float64: rows map to
    channels as the kernel maps them (row % C)."""
    a = alpha.double()
    b = (beta if beta is not None else alpha).double()
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    inv_b = 1.0 / (b + 1e-9)

    def act(v, rows):
        c = rows % alpha.shape[0]
        shape = (-1,) + (1,) * (v.dim() - 1)
        return v + inv_b[c].view(shape) * torch.sin(a[c].view(shape) * v) ** 2
    return act


def emulate_kernel(x, alpha, beta, logscale=True, vec=True):
    """Kernel A's launch on [B, C, T] in float64, block by block of its
    one-dimensional grid; ``vec`` as the entry point sets it (T % 4 == 0
    and 16-byte aligned pointers). Each output is written exactly once."""
    bsz, c, t = x.shape
    xr = x.reshape(bsz * c, t).double()
    h = torch.from_numpy(kaiser_sinc_filter1d(0.25, 0.3, 12)).double()
    up, dn = 2.0 * h, h
    act = _act(alpha, beta, logscale)
    tiles = -(-t // TILE)
    y = torch.zeros_like(xr)
    written = torch.zeros((bsz * c, t), dtype=torch.int64)
    k6, lanes = torch.arange(6), torch.arange(32)
    for blk0 in range(0, bsz * c * tiles, ROW_CHUNK * tiles):
        blocks = torch.arange(blk0, min(blk0 + ROW_CHUNK * tiles,
                                        bsz * c * tiles))
        rows_all, tiles_all = blocks // tiles, blocks % tiles  # the grid
        for tl in range(tiles):
            rows = rows_all[tiles_all == tl]
            x_rows = xr[rows]
            interior = vec and tl > 0 and (tl + 1) * TILE + 8 <= t

            def xat(idx):
                if interior:
                    assert 0 <= int(idx.min()) and int(idx.max()) < t
                    return x_rows[:, idx]
                return x_rows[:, idx.clamp(0, t - 1)]

            def s_at(idx):  # s at 2x-rate indices idx (any shape)
                m, par = torch.div(idx, 2, rounding_mode="floor"), idx % 2
                xs = xat((m - 3 + par)[..., None] + k6)
                w = torch.where(par[..., None] == 1, up[1::2], up[0::2])
                return act((xs * w).sum(-1), rows)

            w0 = tl * TILE + torch.arange(WARPS) * 32 * R    # [W]
            # a warp that starts at or past T stores nothing and feeds no
            # other warp (each computes its own outer halos): skipped
            w0 = w0[w0 < t]
            n0 = w0[:, None] + lanes * R                     # [W, 32]
            xw = xat(n0[..., None] - 4 + torch.arange(R + 8))  # [rows, W, 32, XW]
            i = torch.arange(R)[:, None]
            se = (xw[..., i + 1 + k6] * up[0::2]).sum(-1)    # [rows, W, 32, R]
            so = (xw[..., i + 2 + k6] * up[1::2]).sum(-1)
            sw = torch.zeros(xw.shape[:3] + (2 * R + 10,), dtype=torch.float64)
            sw[..., 5:2 * R + 5:2] = act(se, rows)
            sw[..., 6:2 * R + 6:2] = act(so, rows)
            q = torch.arange(5)
            outer_l = s_at(2 * w0[:, None] - 5 + q)          # lanes 0..4
            outer_r = s_at(2 * (w0[:, None] + 32 * R) + q)   # lanes 5..9
            own = sw.clone()
            sw[..., 1:, :5] = own[..., :-1, 2 * R:2 * R + 5]  # __shfl_up_sync
            sw[..., :-1, 2 * R + 5:] = own[..., 1:, 5:10]     # __shfl_down_sync
            sw[..., 0, :5] = outer_l
            sw[..., 31, 2 * R + 5:] = outer_r
            idx = 2 * n0[..., None] - 5 + torch.arange(2 * R + 10)
            if interior:
                assert int(idx.min()) >= 0 and int(idx.max()) <= 2 * t - 1
            else:  # the down stage's replicate edges
                s_lo = s_at(torch.tensor(0)).view(-1, 1, 1, 1)
                s_hi = s_at(torch.tensor(2 * t - 1)).view(-1, 1, 1, 1)
                sw = torch.where(idx < 0, s_lo, sw)
                sw = torch.where(idx > 2 * t - 1, s_hi, sw)
            out = (sw[..., 2 * i + torch.arange(12)] * dn).sum(-1)  # [rows, W, 32, R]
            n = (n0[..., None] + torch.arange(R)).reshape(-1)
            keep = n < t
            assert interior is False or bool(keep.all())
            y[rows[:, None], n[keep]] = out.reshape(len(rows), -1)[:, keep]
            written[rows[:, None], n[keep]] += 1
    assert bool((written == 1).all())
    return y.reshape(bsz, c, t)


def _inputs(seed, bsz, c, t, with_beta=True, logscale=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, c, t)).astype(np.float32))
    a = torch.from_numpy((rng.standard_normal(c) * 0.3).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(c) * 0.3).astype(np.float32))
    if not logscale:
        a, b = a.abs() + 0.5, b.abs() + 0.5
    return x, a, b if with_beta else None


STRUCTURE_T = [1, 2, 5, 11, 12, 13, TILE - 1, TILE, TILE + 1,
               2 * TILE + R + 1, 2 * TILE + 8, 3 * TILE + 12]


@pytest.mark.parametrize("t", STRUCTURE_T)
def test_strips_and_halos_compute_the_plain_function(t):
    # f64 emulation against the f32 plain version: their difference is the
    # plain version's f32 rounding; a wrong index moves outputs by ~1e-1
    x, a, b = _inputs(t, 2, 3, t)
    want = ops.snake_activation1d_plain(x, a, b).double()
    for vec in (True, False):
        got = emulate_kernel(x, a, b, vec=vec)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("with_beta,logscale", [(False, True), (True, False)])
def test_strips_and_halos_plain_snake_and_linear_scale(with_beta, logscale):
    t = 2 * TILE + 8
    x, a, b = _inputs(7, 1, 2, t, with_beta, logscale)
    torch.testing.assert_close(
        emulate_kernel(x, a, b, logscale),
        ops.snake_activation1d_plain(x, a, b, logscale).double(),
        atol=1e-6, rtol=1e-6)


def test_grid_takes_rows_beyond_65535():
    # the one-dimensional grid's (row, tile) and each row's channel
    bsz, c, t = 2, 32800, 5
    x, a, b = _inputs(3, bsz, c, t)
    got = emulate_kernel(x, a, b)
    torch.testing.assert_close(got, ops.snake_activation1d_plain(x, a, b)
                               .double(), atol=1e-6, rtol=1e-6)


def test_interior_tiles_need_no_clamp():
    # the rule of snake_aa_kernel: every x read and s position of a tile
    # with t0 > 0 and t0 + TILE + 8 <= T lies in range (the emulation
    # asserts it), and T = that bound exactly makes the last full tile
    # interior
    t = 3 * TILE + 8
    x, a, b = _inputs(11, 1, 1, t)
    torch.testing.assert_close(emulate_kernel(x, a, b),
                               ops.snake_activation1d_plain(x, a, b).double(),
                               atol=1e-6, rtol=1e-6)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__528898e7_11_snake_aa_cu_0354713715snake_aa_kernelILb0EEEvPKfS2_S2_NS_4TapsEPfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__528898e7_11_snake_aa_cu_0354713715snake_aa_kernelILb0EEEvPKfS2_S2_NS_4TapsEPfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__528898e7_11_snake_aa_cu_0354713715snake_aa_kernelILb1EEEvPKfS2_S2_NS_4TapsEPfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__528898e7_11_snake_aa_cu_0354713715snake_aa_kernelILb1EEEvPKfS2_S2_NS_4TapsEPfiiiii
    32 bytes stack frame, 36 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__0b157620_14_probe_snake_cu_53b91dd917snake_only_kernelILi1EEEvPKfS2_Pfxi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__0b157620_14_probe_snake_cu_53b91dd917snake_only_kernelILi1EEEvPKfS2_Pfxi
    40 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 40 bytes cumulative stack size
"""


def test_chip_smoke_gates_kernel_a_and_g_on_spills():
    # phase 0 fails on a spill in either instance of A or in G (the log:
    # A with the precise sinf, which spilled, and the parent's G)
    from test_torch_convt_plan import _chip_smoke
    cs = _chip_smoke()
    entries = cs.ptxas_entries(PTXAS_LOG)
    assert entries == [("snake_aa_kernel", "", 54, (0, 0)),
                       ("snake_aa_kernel", "", 48, (36, 44)),
                       ("snake_only_kernel", "1", 32, (4, 4))]
    assert [(k, r) for k, _, r, sp in entries
            if k in cs.NO_SPILL and sp != (0, 0)] == [
        ("snake_aa_kernel", 48), ("snake_only_kernel", 32)]


# --- the sine ------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding to
    float32 (a rare double rounding through float64 aside)."""
    return (a.double() * b.double() + c.double()).float() if torch.is_tensor(
        a) else _fma(torch.as_tensor(a), b, c)


def sine_emulated(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin_pi_reduced(t), k) of snake.cuh, step for step in float32."""
    c = {k: torch.tensor(v) for k, v in _consts().items()}
    k = _fma(t, c["kInvPi"], c["kRound"]) - c["kRound"]
    r = _fma(-k, c["kPi1"], t)
    r = _fma(-k, c["kPi2"], r)
    r2 = r * r
    p = _fma(c["kS9"].expand_as(r2), r2, c["kS7"])
    p = _fma(p, r2, c["kS5"])
    p = _fma(p, r2, c["kS3"])
    return _fma(p * r2, r, r), k


def test_sine_constants_are_the_stated_ones():
    c = _consts()
    assert sorted(c) == ["kInvPi", "kPi1", "kPi2", "kRound", "kS3", "kS5",
                         "kS7", "kS9"]
    assert c["kPi1"] == np.float32(np.pi)
    assert abs(float(c["kPi1"]) + float(c["kPi2"]) - np.pi) < 1e-14
    assert c["kRound"] == 1.5 * 2 ** 23
    assert f"float64:\n// {SINE_BOUND_TEXT} over" in SINE_SRC


@pytest.mark.parametrize("part", ["uniform", "near_half_pi", "small",
                                  "top_binade"])
def test_sine_within_its_stated_bound(part):
    rng = np.random.default_rng(["uniform", "near_half_pi", "small",
                                 "top_binade"].index(part))
    n = 1_000_000
    if part == "uniform":
        t = rng.uniform(-2 ** 15, 2 ** 15, n)
    elif part == "near_half_pi":  # where the reduction rounds k either way
        t = (rng.integers(-20860, 20860, n) * (np.pi / 2)
             + rng.normal(0, 1e-3, n))
    elif part == "small":
        t = np.exp(rng.uniform(np.log(1e-8), np.log(4.0), n)) \
            * rng.choice([-1, 1], n)
    else:  # every 8th float32 in [2^14, 2^15)
        t = (np.arange(0, 2 ** 23, 8, dtype=np.uint32)
             | np.uint32(141 << 23)).view(np.float32)
    t = torch.from_numpy(np.asarray(t, np.float32))
    t = t[t.abs() <= 2 ** 15]
    s, k = sine_emulated(t)
    sign = 1.0 - 2.0 * (k.double().abs() % 2)
    err = (sign * s.double() - torch.sin(t.double())).abs()
    assert float(err.max()) <= SINE_BOUND


def test_snake_with_the_sine_matches_the_plain_snake():
    # snake_fn: fma(inv_b, p * p, u) with p the sine of a * u
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32) * 4)
    a = torch.from_numpy(np.exp(rng.standard_normal(100_000) * 0.3)
                         .astype(np.float32))
    inv_b = torch.from_numpy(np.exp(rng.standard_normal(100_000) * 0.3)
                             .astype(np.float32))
    p, _ = sine_emulated(a * u)
    got = _fma(inv_b, p * p, u)
    want = u.double() + inv_b.double() * torch.sin((a * u).double()) ** 2
    assert float((got.double() - want).abs().max()) <= \
        2 * SINE_BOUND * float(inv_b.max()) + 4 * 2 ** -24 * float(
            want.abs().max())


# --- the edge: the port's function against the JAX package ----------------------

def _unfused(x, a, b):
    y = jax_bigvgan.upsample1d(x, 2, 12)
    return jax_bigvgan.downsample1d(jax_bigvgan.snake_beta(y, a, b, True),
                                    2, 12)


_UNFUSED = jax.jit(_unfused)
_FUSED = jax.jit(lambda x, a, b: fused_snake_activation1d(x, a, b, True, True))


@pytest.mark.parametrize("t", [1, 3, 5, 7, 13, 100, 1025])
def test_plain_is_the_unfused_composition_the_fused_kernel_departs(t):
    x, a, b = _inputs(t, 2, 8, t)
    got = np.swapaxes(ops.snake_activation1d_plain(x, a, b).numpy(), 1, 2)
    args = (jnp.asarray(np.swapaxes(x.numpy(), 1, 2)), jnp.asarray(a.numpy()),
            jnp.asarray(b.numpy()))
    # the composition: the same f32 function summed in other orders
    np.testing.assert_allclose(got, np.asarray(_UNFUSED(*args)), atol=2e-6,
                               rtol=0)
    fused = np.asarray(_FUSED(*args))
    # the fused kernel as tests/test_torch_ops.py holds it (f32
    # reassociation and its polynomial cos), but for its last samples where
    # _pick_tile finds no tile: there it fixes the padded length's edge
    n = min(3, t) if _pick_tile(t) == 0 and t > 1 else 0
    np.testing.assert_allclose(got[:, :t - n], fused[:, :t - n], atol=2e-5,
                               rtol=1e-4)
    if n:
        assert float(np.abs(got[:, t - n:] - fused[:, t - n:]).max()) > 1e-4
