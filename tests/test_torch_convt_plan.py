"""What surrounds kernel C (csrc/conv_transpose1d.cu) on the host, on the
CPU: its weight layout and cache, its polyphase plan, and the accuracy of
the 3xTF32 products its float32 instance takes on the card. No JAX."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowhigh_tpu_torch import FlowHighConfig, ops
from flowhigh_tpu_torch.ops import conv as conv_mod
from flowhigh_tpu_torch.ops.quant import round_bf16

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# the kernel's (stride, K) instances: BigVGAN's upsamplers and (8, 16)
INSTANCES = [(5, 11), (4, 8), (3, 7), (2, 4), (8, 16)]


def _randn(gen, *shape, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def polyphase(x, w, b, stride, mul=None):
    """ConvTranspose1d from ``convt_phase_plan``: for each tap j, output
    phase r gets w[:, :, j]^T x shifted by q, summed over the taps in
    float64 unless ``mul(w_j, x_shifted)`` does the product."""
    bsz, cin, t = x.shape
    cout = w.shape[1]
    y = torch.zeros((bsz, cout, stride, t), dtype=torch.float64)
    for j, r, q in conv_mod.convt_phase_plan(stride, w.shape[-1]):
        xs = torch.zeros_like(x)
        lo, hi = max(0, -q), min(t, t - q)
        xs[..., lo:hi] = x[..., lo + q:hi + q]
        if mul is None:
            y[:, :, r] += torch.einsum("io,bit->bot", w[:, :, j].double(),
                                       xs.double())
        else:
            y[:, :, r] += mul(w[:, :, j], xs).double()
    y = y.permute(0, 1, 3, 2).reshape(bsz, cout, stride * t)
    return y if b is None else y + b.double()[:, None]


@pytest.mark.parametrize("u,k", INSTANCES)
def test_phase_plan_covers_every_tap_once(u, k):
    plan = conv_mod.convt_phase_plan(u, k)
    p = (k - u) // 2
    assert [j for j, _, _ in plan] == list(range(k))
    for j, r, q in plan:
        assert 0 <= r < u and r + p - j == u * q
    # the kernel's shift range (csrc/conv_transpose1d.cu: Plan::QLO, QHI)
    qs = [q for _, _, q in plan]
    assert min(qs) >= -((k - 1 - p + u - 1) // u)
    assert max(qs) <= (u - 1 + p) // u
    # each phase meets about K/U taps
    counts = np.bincount([r for _, r, _ in plan], minlength=u)
    assert counts.max() - counts.min() <= 1 and counts.sum() == k


@pytest.mark.parametrize("u,k", INSTANCES)
@pytest.mark.parametrize("bsz,cin,cout,t", [(2, 40, 24, 37), (1, 16, 48, 5)])
def test_polyphase_plan_equals_plain(u, k, bsz, cin, cout, t):
    gen = np.random.default_rng(u * 100 + k + cin)
    x = _randn(gen, bsz, cin, t)
    w = _randn(gen, cin, cout, k, scale=(cout * k) ** -0.5)
    b = _randn(gen, cout, scale=0.1)
    want = ops.conv_transpose1d_plain(x, w, b, stride=u)
    assert want.shape == (bsz, cout, u * t)
    torch.testing.assert_close(polyphase(x, w, b, u).float(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout,k", [(40, 24, 11), (1536, 768, 4),
                                        (96, 48, 8), (16, 64, 16)])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_round_trips(cin, cout, k, dot_dtype):
    w = _randn(np.random.default_rng(cin + k), cin, cout, k)
    lay = conv_mod.convt_weight_layout(w, dot_dtype)
    cin_p = -(-cin // conv_mod.CONVT_CIN_ALIGN) * conv_mod.CONVT_CIN_ALIGN
    cout_p = -(-cout // conv_mod.CONVT_COUT_ALIGN) * conv_mod.CONVT_COUT_ALIGN
    assert lay.shape == (k, cout_p, cin_p) and lay.is_contiguous()
    assert lay.dtype == dot_dtype
    want = w if dot_dtype == torch.float32 else round_bf16(w)
    assert torch.equal(lay[:, :cout, :cin].float().permute(2, 1, 0), want)
    assert not lay[:, cout:].any() and not lay[:, :, cin:].any()


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_is_cached_by_version(dot_dtype):
    w = _randn(np.random.default_rng(1), 24, 16, 8)
    first = conv_mod.convt_weights(w, dot_dtype)
    assert conv_mod.convt_weights(w, dot_dtype) is first
    with torch.no_grad():
        w.mul_(2.0)  # an in-place write bumps the version counter
    again = conv_mod.convt_weights(w, dot_dtype)
    assert again is not first
    assert torch.equal(again.float(), 2.0 * first.float())
    # the other instance's layout is cached beside it, not in its place
    other = torch.bfloat16 if dot_dtype == torch.float32 else torch.float32
    assert conv_mod.convt_weights(w, other).dtype == other
    assert conv_mod.convt_weights(w, dot_dtype) is again


def tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    by bit masking: cvt.rna.tf32.f32 on the card."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def test_tf32_split_round_trips():
    v = _randn(np.random.default_rng(2), 4096) * torch.logspace(-3, 3, 4096)
    hi, lo = split(v)
    for part in (hi, lo):  # both TF32 values: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.all((hi.double() - v.double()).abs()
                     <= 2.0 ** -11 * v.double().abs())
    assert torch.all((hi.double() + lo.double() - v.double()).abs()
                     <= 2.0 ** -22 * v.double().abs())


def test_3xtf32_meets_f32_accuracy_at_stage1_depth():
    # stage 1 of BigVGAN's default: Cin 1536, (5, 11); a narrow Cout and T.
    # Each TF32 x TF32 product is exact in f32, and each term is summed in
    # f32, as the card's tensor cores sum them
    u, k, cin, cout, t = 5, 11, 1536, 8, 40
    gen = np.random.default_rng(3)
    x = _randn(gen, 1, cin, t)
    w = _randn(gen, cin, cout, k, scale=(cout * k) ** -0.5)

    def mul3(wj, xs):
        (wh, wl), (xh, xl) = split(wj), split(xs)
        term = lambda a, b: torch.einsum("io,bit->bot", a, b)  # noqa: E731
        return term(wl, xh) + term(wh, xl) + term(wh, xh)

    exact = polyphase(x, w, None, u)
    got = polyphase(x, w, None, u, mul=mul3)
    err = float((got - exact).abs().max() / exact.abs().max())
    assert err <= 1e-5, err
    # one TF32 product would not meet the 1e-4 bound of the card's checks
    one = polyphase(x, w, None, u,
                    mul=lambda wj, xs: torch.einsum("io,bit->bot", tf32(wj),
                                                    tf32(xs)))
    assert float((one - exact).abs().max() / exact.abs().max()) > 1e-4


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("instance,bound_ms,per_stage_ms", [
    # 3xTF32: three TF32 products per f32 product at 495 TFLOP/s
    ("conv_transpose1d", 0.62, (0.157, 0.143, 0.143, 0.125, 0.055)),
    # bf16: bytes at 3.35 TB/s where they exceed the tensor cores' time
    ("conv_transpose1d.bf16", 0.18, (0.026, 0.024, 0.028, 0.046, 0.055))])
def test_chip_smoke_bounds_kernel_c_by_its_instruction(instance, bound_ms,
                                                       per_stage_ms):
    # chip_smoke.py's bound of kernel C at the five upsamplers of a 10 s
    # clip on an H100 SXM: 102.6 GFLOP over 562 MB
    cs = _chip_smoke()
    peaks = cs.card_peaks("NVIDIA H100 80GB HBM3")
    calls = cs.main_path_calls(FlowHighConfig().vocoder, 1000)
    keys = sorted(calls["conv_transpose1d"], key=lambda k: -k[0])
    assert len(keys) == 5
    flops = byt = total = 0.0
    for key, want in zip(keys, per_stage_ms):
        b, dots, other = cs.work(instance, key)
        ms = max(b / peaks[1], cs.dot_seconds(peaks, instance, dots)
                 + other / peaks[0]) * 1e3
        assert ms == pytest.approx(want, abs=1.5e-3), key
        flops, byt, total = flops + dots, byt + b, total + ms
    assert flops == pytest.approx(102.6e9, rel=1e-3)
    assert byt == pytest.approx(562e6, rel=2e-3)
    assert total == pytest.approx(bound_ms, abs=0.01)
    # the other instances keep their dtype's unit (kernel B's float32 GEMM
    # route and kernels D and E run 3xTF32 too: tests/test_torch_conv_plan.py,
    # tests/test_torch_act_conv_plan.py)
    assert cs.dot_seconds(peaks, "act_conv1d", 495e12) == pytest.approx(3.0)
    assert cs.dot_seconds(peaks, "act_conv1d.int8", 1979e12) == \
        pytest.approx(1.0)
    assert cs.dot_seconds(peaks, "conv1d_same.bf16", 989e12) == \
        pytest.approx(1.0)
