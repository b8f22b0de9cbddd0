#!/usr/bin/env python3
"""Smoke run of flowhigh_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. print the card (nvidia-smi name, power limit) and build the CUDA kernels
   from flowhigh_tpu_torch/csrc with nvcc (all sources in parallel);
1. hold every vocoder kernel against its plain PyTorch version on the card
   at every shape a 10 s, 16 kHz clip gives it on both vocoder paths, the
   default (``fuse_act_conv=True``: kernels A-E) and the unfused one
   (``fuse_act_conv=False``: A, B, C), and at every shape of the long-form
   path's vocoder windows (1,064 frames), atol 1e-4, rtol 1e-4; time the
   kernel, the plain version and the one PyTorch library call that computes
   the same function where there is one (CUDA events, median of 15 after 3
   warm-up launches). No single PyTorch call computes kernel D or E; their
   yardstick is the port's own unfused chain of kernels A and B for the same
   work (``unfused_chain_ms``). Kernel F (flash attention) is held against
   its plain version over every row, masked rows included, at H = 16,
   D = 64, B in {1, 2} and N in {128, 1,000 (950 valid), 4,096 (4,000
   valid)}: atol 1e-4 within one block, max 5e-3 and mean 1e-4 over
   several; at the long-form shape, N = 30,000, 256 random query rows per
   head against an exact float64 softmax. Its yardstick is
   ``F.scaled_dot_product_attention`` with a boolean segment mask on the
   memory-efficient backend;
2. run FlowHighSR.generate at full width (FlowHighConfig() defaults, seeded
   random weights) on a 10 s, 16 kHz clip, first on the default path, then
   on the unfused path: launch counts of every kernel on each run (zeroed
   just before, read just after, held against ``main_path_calls``), output
   shape and finiteness, the two paths' outputs against each other, median
   ms per clip and RTF of each;
S. serving: ServingPipeline over 12 x 10 s clips with at most 8 in flight,
   float32 and int16 wire: sustained RTF; a pinned-seed request against
   ``generate``; ``generate_batch`` on 4 clips at 16 and 8 kHz against
   per-clip ``generate`` (max abs diff <= 1e-4);
3. run a 1 s clip through the same weights on the card (default path) and
   on the CPU (plain versions): max abs waveform difference <= 1e-3; also
   report the card-vs-CPU difference of the log-mel (float32 and float64
   STFT) and of the vocoder alone on one mel;
L. long-form: the same weights with ``ModelConfig(attn_flash=True)`` run
   ``generate_longform`` single-pass on a 300 s, 16 kHz clip (vocoder
   windows of 1,000 + 2 x 32 frames): launch counts (F 2, the vocoder's per
   window x 30), output shape and finiteness, wall time (median of 3 after
   the counted run) as RTF, peak device memory, device ms of F against the
   vocoder (torch.profiler, one run). Checks on 10 s: ``generate_longform``
   against ``generate`` (<= 2e-4), ``vocode_chunked`` against the whole
   vocoder on a 2,000-frame mel (<= 1e-5), the flash model's ``generate``
   against phase 2's dense one (<= 1e-3). StreamingSR on a 60 s clip (10 s
   chunks, 1 s overlap): RTF on the float32 and int16 wires, int16 within
   1e-4 of float32, seam LSD against the single-pass output below
   max(2.0, 2.5 x overall LSD);
4. print the ``kernels`` JSON line (per kernel: the default path's launches
   and the per-clip sums over them, the unfused path's in ``unfused_path``,
   the long-form path's in ``longform_path``; kernel F's launches and sums
   are per long-form clip), the card line and, last, the ``ok`` line.

Per-shape numbers go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SECONDS, IN_SR = 10.0, 16000
ATOL = RTOL = 1e-4
REPS, WARMUP = 15, 3
# long-form: clip, vocoder windows (the JAX package's defaults)
LONG_SECONDS, CHUNK, OVERLAP = 300.0, 1000, 32

# published peaks (NVIDIA data sheets): f32 FMA-unit FLOP/s, memory B/s
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}


def card_peaks(name: str) -> tuple[float, float]:
    low = name.lower()
    if "pcie" in low:
        return PEAKS["pcie"]
    if "nvl" in low:
        return PEAKS["nvl"]
    return PEAKS["sxm"]


# --- main-path shapes of a clip -------------------------------------------------

KERNEL_NAMES = ("snake_aa", "conv1d_same", "conv_transpose1d", "act_conv1d",
                "amp_unit")  # the vocoder's, in ops.KERNELS order
FLASH = "flash_attn"
ALL_KERNELS = KERNEL_NAMES + (FLASH,)


def main_path_calls(cfg, frames: int, fuse_act_conv=True):
    """Every kernel call of one BigVGAN forward over ``frames`` mel frames,
    routed as ``models/bigvgan.py`` routes it (the port's plans):
    {kernel: {shape key: launches}}. Keys: snake (C, T); conv and act_conv
    (Cin, Cout, T, K, d, n_res, out_scale); convt (Cin, Cout, T_in, u, K);
    amp_unit (C, T, K, d, n_extra, out_scale)."""
    from flowhigh_tpu_torch.ops import act_conv_plan, amp_unit_plan
    calls = {k: {} for k in KERNEL_NAMES}

    def add(kernel, key, n=1):
        calls[kernel][key] = calls[kernel].get(key, 0) + n

    def pair(ch, t, k, d, n_res, scale):
        fuse = k <= 3 if fuse_act_conv == "auto" else bool(fuse_act_conv)
        if fuse and act_conv_plan(k, d, ch, t):
            add("act_conv1d", (ch, ch, t, k, d, n_res, scale))
        else:
            add("snake_aa", (ch, t))
            add("conv1d_same", (ch, ch, t, k, d, n_res, scale))

    ch, t = cfg.upsample_initial_channel, frames
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout = cfg.upsample_initial_channel // 2 ** (i + 1)
        add("conv_transpose1d", (ch, cout, t, u, k))
        ch, t = cout, t * u
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for m, d in enumerate(rd):
                last = j == nk - 1 and m == len(rd) - 1
                n_extra, scale = (nk - 1, 1.0 / nk) if last else (0, 1.0)
                if fuse_act_conv is True and amp_unit_plan(rk, d, ch, t):
                    add("amp_unit", (ch, t, rk, d, n_extra, scale))
                    continue
                pair(ch, t, rk, d, 0, 1.0)
                pair(ch, t, rk, 1, 1 + n_extra, scale)
    add("snake_aa", (ch, t))
    add("conv1d_same", (ch, 1, t, 7, 1, 0, 1.0))
    return calls


def longform_calls(cfg, frames: int, chunk: int = CHUNK,
                   overlap: int = OVERLAP):
    """``main_path_calls`` of ``FlowHighSR.vocode_chunked``: one whole
    forward when ``frames`` fits one window, else ceil(frames / chunk)
    windows of chunk + 2 * overlap frames."""
    window = chunk + 2 * overlap
    if frames <= window:
        return main_path_calls(cfg, frames)
    n = -(-frames // chunk)
    return {k: {key: c * n for key, c in v.items()}
            for k, v in main_path_calls(cfg, window).items()}


SNAKE_OPS = 56.0  # per sample: 2 x 6 up taps, snake on 2 samples, 12 down


def work(kernel: str, key) -> tuple[float, float]:
    """(bytes moved: each input read once, each output written once;
    operations) of one call."""
    if kernel == "snake_aa":
        c, t = key
        return 4.0 * (2 * c * t + 2 * c + 12), SNAKE_OPS * c * t
    if kernel in ("conv1d_same", "act_conv1d"):
        cin, cout, t, k, _, n_res, _ = key
        byt = 4.0 * (cin * t + cout * cin * k + cout + (n_res + 1) * cout * t)
        ops = 2.0 * cin * cout * k * t + (n_res + 2.0) * cout * t
        if kernel == "act_conv1d":
            return byt + 4.0 * (2 * cin + 12), ops + SNAKE_OPS * cin * t
        return byt, ops
    if kernel == "amp_unit":
        c, t, k, _, n_extra, _ = key
        byt = 4.0 * (c * t + 2 * c * c * k + 2 * c + 4 * c + 12
                     + (n_extra + 1) * c * t)
        ops = (4.0 * c * c * k * t + 2 * SNAKE_OPS * c * t
               + (n_extra + 3.0) * c * t)
        return byt, ops
    cin, cout, t, u, k = key
    return (4.0 * (cin * t + cin * cout * k + cout + cout * u * t),
            2.0 * cin * cout * k * t + cout * u * t)


# --- timing --------------------------------------------------------------------

def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median of ``reps`` single-launch CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _compare(name: str, key, got, want) -> tuple[float, float]:
    import torch
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp(min=1e-12)).max())
    ok = bool(torch.all(diff <= ATOL + RTOL * want.abs()))
    print(f"  {name} {key}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name} at {key} disagrees with its plain version "
                             f"beyond atol={ATOL}, rtol={RTOL}")
    return max_abs, max_rel


def _cases(kernel: str, key, randn):
    """(kernel call, plain call, library call or None, unfused A+B chain or
    None) on fresh inputs of one shape key."""
    import torch.nn.functional as F

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.utils import cudnn_f32

    def act_params(c):
        return randn(c, scale=0.3), randn(c, scale=0.3)

    if kernel == "snake_aa":
        c, t = key
        x = randn(1, c, t)
        a, b = act_params(c)
        return (lambda: ops.snake_activation1d(x, a, b, True),
                lambda: ops.snake_activation1d_plain(x, a, b, True), None, None)
    if kernel in ("conv1d_same", "act_conv1d"):
        cin, cout, t, k, d, n_res, scale = key
        x = randn(1, cin, t)
        w = randn(cout, cin, k, scale=(cin * k) ** -0.5)
        b = randn(cout, scale=0.1)
        res = tuple(randn(1, cout, t) for _ in range(n_res))
        kw = dict(dilation=d, residuals=res, out_scale=scale)
        if kernel == "act_conv1d":
            a, be = act_params(cin)
            return (lambda: ops.act_conv1d(x, a, be, True, w, b, **kw),
                    lambda: ops.act_conv1d_plain(x, a, be, True, w, b, **kw),
                    None,
                    lambda: ops.conv1d(ops.snake_activation1d(x, a, be, True),
                                       w, b, **kw))

        def lib():
            with cudnn_f32():
                return F.conv1d(x, w, b, padding=d * (k - 1) // 2, dilation=d)
        return (lambda: ops.conv1d(x, w, b, **kw),
                lambda: ops.conv1d_plain(x, w, b, **kw), lib, None)
    if kernel == "amp_unit":
        c, t, k, d, n_extra, scale = key
        x = randn(1, c, t)
        a1, b1 = act_params(c)
        a2, b2 = act_params(c)
        w1 = randn(c, c, k, scale=(c * k) ** -0.5)
        w2 = randn(c, c, k, scale=(c * k) ** -0.5)
        bias1, bias2 = randn(c, scale=0.1), randn(c, scale=0.1)
        ex = tuple(randn(1, c, t) for _ in range(n_extra))
        args = (x, a1, b1, a2, b2, True, w1, bias1, w2, bias2)
        kw = dict(dilation=d, extra_residuals=ex, out_scale=scale)

        def chain():
            h = ops.conv1d(ops.snake_activation1d(x, a1, b1, True), w1, bias1,
                           dilation=d)
            return ops.conv1d(ops.snake_activation1d(h, a2, b2, True), w2,
                              bias2, residuals=(x,) + ex, out_scale=scale)
        return (lambda: ops.amp_unit(*args, **kw),
                lambda: ops.amp_unit_plain(*args, **kw), None, chain)
    cin, cout, t, u, k = key
    x = randn(1, cin, t)
    w = randn(cin, cout, k, scale=(cout * k) ** -0.5)
    b = randn(cout, scale=0.1)

    def lib():
        with cudnn_f32():
            return F.conv_transpose1d(x, w, b, stride=u, padding=(k - u) // 2)
    return (lambda: ops.conv_transpose1d(x, w, b, stride=u),
            lambda: ops.conv_transpose1d_plain(x, w, b, stride=u), lib, None)


def check_kernels(shapes: dict, device, peaks) -> dict:
    """Phase 1: each kernel against its plain version at every shape key of
    ``shapes`` ({kernel: set of keys}); returns {kernel: {key: row}}."""
    import torch

    flops, bw = peaks
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(device)

    rows: dict = {}
    for kernel, keys in shapes.items():
        rows[kernel] = {}
        for key in sorted(keys):
            run, plain, lib, chain = _cases(kernel, key, randn)
            max_abs, max_rel = _compare(kernel, key, run(), plain())
            byt, ops = work(kernel, key)
            row = {"max_abs_err": max_abs, "max_rel_err": max_rel,
                   "bytes": byt, "ops": ops, "bytes_ms": byt / bw * 1e3,
                   "ops_ms": ops / flops * 1e3, "ms": time_ms(run),
                   "plain_ms": time_ms(plain),
                   "library_ms": time_ms(lib) if lib is not None else None,
                   "unfused_chain_ms": (time_ms(chain) if chain is not None
                                        else None)}
            rows[kernel][key] = row
            del run, plain, lib, chain
    return rows


def path_totals(calls: dict, rows: dict) -> dict:
    """Per-clip sums of the phase-1 rows over one path's launches."""
    out = {}
    for kernel, keys in calls.items():
        if not keys:
            continue
        sel = [(n, rows[kernel][key]) for key, n in keys.items()]
        tot = lambda f: sum(n * r[f] for n, r in sel)  # noqa: E731
        opt = lambda f: (None if sel[0][1][f] is None  # noqa: E731
                         else tot(f))
        bytes_ms, ops_ms = tot("bytes_ms"), tot("ops_ms")
        out[kernel] = {
            "launches": sum(n for n, _ in sel),
            "max_abs_err": max(r["max_abs_err"] for _, r in sel),
            "bound_ms": sum(n * max(r["bytes_ms"], r["ops_ms"]) for n, r in sel),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "library_ms": opt("library_ms"),
            "unfused_chain_ms": opt("unfused_chain_ms"),
            "shapes": [{"key": list(key), "launches": n, **rows[kernel][key]}
                       for key, n in keys.items()],
        }
    return out


# --- kernel F ------------------------------------------------------------------

FLASH_H, FLASH_D, FLASH_SCALE = 16, 64, 10.0  # the model's heads, width, qk scale
# (B, N, valid frames of each row): the mask's tail is False
FLASH_SHAPES = ((1, 128, (128,)), (2, 128, (128, 120)), (1, 1000, (950,)),
                (2, 1000, (950, 998)), (1, 4096, (4000,)),
                (2, 4096, (4000, 4094)))


def flash_work(valids, n: int) -> tuple[float, float]:
    """(bytes: q, k, v read, out written, the mask; operations: the two
    products over the pairs of one segment, which is what these masks
    need) of one call of kernel F."""
    pairs = sum(v * v + (n - v) * (n - v) for v in valids)
    byt = 16.0 * len(valids) * FLASH_H * n * FLASH_D + len(valids) * n
    return byt, 4.0 * FLASH_H * FLASH_D * pairs


def check_flash(peaks, long_frames: int) -> dict:
    """Phase 1, kernel F: against its plain version over every row at
    ``FLASH_SHAPES``, and at the long-form shape (B = 1, N = long_frames,
    all valid) 256 random query rows per head against an exact float64
    softmax; times of the kernel, the plain version and SDPA at each."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.ops.flash_attn import flash_block

    flops, bw = peaks
    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).cuda()

    def row(valids, n, err_max, err_mean, reps, warmup, fns):
        byt, opn = flash_work(valids, n)
        run, plain, lib = fns
        return {"max_abs_err": err_max, "mean_abs_err": err_mean,
                "bytes": byt, "ops": opn, "bytes_ms": byt / bw * 1e3,
                "ops_ms": opn / flops * 1e3,
                "ms": time_ms(run, reps, warmup),
                "plain_ms": time_ms(plain, reps, warmup),
                "library_ms": time_ms(lib, reps, warmup)}

    rows = {}
    for b, n, valids in FLASH_SHAPES + ((1, long_frames, (long_frames,)),):
        q, k, v = (randn(b, FLASH_H, n, FLASH_D) for _ in range(3))
        mask = (torch.arange(n, device="cuda")[None, :]
                < torch.tensor(valids, device="cuda")[:, None])
        # SDPA's mask: the pairs of one segment (it has no pad keys, so a
        # masked row's softmax differs from F's; it is a yardstick only)
        same = (mask[:, None, :, None] == mask[:, None, None, :])

        def lib():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=same, scale=FLASH_SCALE)

        fns = (lambda: ops.flash_attention(q, k, v, mask, FLASH_SCALE),
               lambda: ops.flash_attention_plain(q, k, v, mask, FLASH_SCALE),
               lib)
        got = fns[0]()
        if n == long_frames:
            sel = torch.from_numpy(np.stack([rng.choice(n, 256, replace=False)
                                             for _ in range(FLASH_H)])).cuda()
            qs = torch.gather(q[0].double(), 1,
                              sel[..., None].expand(-1, -1, FLASH_D))
            s = torch.matmul(qs, k[0].double().transpose(-1, -2)) * FLASH_SCALE
            want = torch.matmul(s.softmax(dim=-1), v[0].double())
            got = torch.gather(got[0].double(), 1,
                               sel[..., None].expand(-1, -1, FLASH_D))
            del s
            reps, warmup = 5, 1
        else:
            want = fns[1]().double()
            reps, warmup = REPS, WARMUP
        d = (got.double() - want).abs()
        err_max, err_mean = float(d.max()), float(d.mean())
        single = flash_block(n) >= n
        ok = (bool(torch.isfinite(got).all())
              and (err_max <= 1e-4 if single
                   else err_max < 5e-3 and err_mean < 1e-4))
        key = (b, n) + tuple(valids)
        print(f"  flash_attn {key}: max_abs {err_max:.3e} mean_abs "
              f"{err_mean:.3e} ({'one block, atol 1e-4' if single else 'several blocks, max 5e-3, mean 1e-4'}"
              f"{', 256 rows per head vs float64' if n == long_frames else ', every row'}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attn at {key} disagrees with its "
                                 "reference")
        del got, want, d
        rows[key] = row(valids, n, err_max, err_mean, reps, warmup, fns)
        r = rows[key]
        print(f"    {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, SDPA "
              f"{r['library_ms']:.3f}, bound {max(r['bytes_ms'], r['ops_ms']):.3f})",
              flush=True)
        del q, k, v, mask, same, fns
    return rows


# --- end to end ----------------------------------------------------------------

def make_sr(config, device: str, seed: int = 0, fuse_act_conv=True):
    from flowhigh_tpu_torch import FlowHighSR
    sr = FlowHighSR(config, cfm_method="independent_cfm_adaptive",
                    ode_method="euler", fuse_act_conv=fuse_act_conv,
                    device=device)
    sr.init_params(seed)
    return sr


def launch_counts() -> dict:
    from flowhigh_tpu_torch import ops
    return {k: fn.launches for k, fn in zip(ALL_KERNELS, ops.KERNELS)}


def run_main_path(sr, audio: np.ndarray, in_sr: int) -> tuple[np.ndarray, dict]:
    """One generate with every launch count zeroed just before and read just
    after."""
    from flowhigh_tpu_torch import ops
    ops.reset_launch_counts()
    out = sr.generate(audio, in_sr, timestep=1)
    return out, launch_counts()


def clip_ms_of(sr, audio: np.ndarray, reps: int = 5) -> list:
    """Host ms of ``reps`` generates, each ending in a synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr.generate(audio, IN_SR, timestep=1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def check_launches(what: str, counts: dict, calls: dict,
                   flash: int = 0) -> None:
    expected = {k: sum(calls[k].values()) for k in KERNEL_NAMES}
    expected[FLASH] = flash
    print(f"{what}: launches {counts} (expected {expected})", flush=True)
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")


def serving_phase(sr) -> dict:
    """ServingPipeline over 12 x 10 s clips (float32 and int16 wire) and
    generate_batch on 4 mixed-rate clips against per-clip generate."""
    from flowhigh_tpu_torch.profiling import clip_signal
    from flowhigh_tpu_torch.serving import ServingPipeline

    n_clips = 12
    rng = np.random.default_rng(1)
    base = clip_signal(SECONDS, IN_SR)
    clips = [(base * (0.6 + 0.4 * rng.random())).astype(np.float32)
             for _ in range(n_clips)]
    res: dict = {}
    for wire in ("float32", "int16"):
        with ServingPipeline(sr, max_in_flight=8, wire=wire) as srv:
            srv.warmup(IN_SR, SECONDS)
            t0 = time.perf_counter()
            outs = srv.generate_many(clips, IN_SR)
            wall = time.perf_counter() - t0
            pinned = srv.submit(clips[0], IN_SR, seed=0).result()
            errors = list(srv._pipe.stage_errors)
        if errors or any(o.shape != (1, int(SECONDS * 48000))
                         or not np.isfinite(o).all() for o in outs):
            raise AssertionError(f"serving ({wire}) failed: {errors}")
        direct = sr.generate(clips[0], IN_SR, timestep=1, seed=0)
        pinned_diff = float(np.abs(pinned - direct).max())
        limit = 0.0 if wire == "float32" else 0.5 / 32767 + 1e-7
        res[wire] = {"clips": n_clips, "wall_s": wall,
                     "rtf": n_clips * SECONDS / wall,
                     "pinned_seed_vs_generate": pinned_diff}
        print(f"serving ({wire} wire): {n_clips} x {SECONDS:g} s clips in "
              f"{wall:.3f} s, sustained RTF {n_clips * SECONDS / wall:.1f}; "
              f"pinned seed vs generate {pinned_diff:.3e}", flush=True)
        if not pinned_diff <= limit:
            raise AssertionError(f"serving ({wire}) differs from generate")

    srs = [16000, 8000, 16000, 8000]
    mixed = [clip_signal(SECONDS, r) * np.float32(0.5 + 0.1 * i)
             for i, r in enumerate(srs)]
    batch = sr.generate_batch(mixed, srs, timestep=1)
    single = [sr.generate(a, r, timestep=1) for a, r in zip(mixed, srs)]
    batch_diff = max(float(np.abs(b - s).max()) for b, s in zip(batch, single))
    res["generate_batch_vs_generate"] = batch_diff
    print(f"serving: generate_batch (4 clips, 16 and 8 kHz) vs per-clip "
          f"generate max abs diff {batch_diff:.3e}", flush=True)
    if not batch_diff <= 1e-4:
        raise AssertionError(f"generate_batch differs: {batch_diff}")
    return res


def stage_diffs(sr_gpu, sr_cpu, audio: np.ndarray) -> dict:
    """Max abs card-vs-CPU differences of the pieces of one clip: the
    log-mel with its STFT in float32 and in float64 (the encode's), and the
    vocoder alone on one mel (the default path's kernels against the plain
    versions)."""
    import torch

    from flowhigh_tpu_torch.dsp import (apply_mel, log_compress,
                                        mel_filterbank, resample_poly,
                                        stft_magnitude)
    from flowhigh_tpu_torch.models import mel_encode

    def log_mel_f32(x):
        mag = stft_magnitude(x, 2048, 480, 2048, center=False,
                             pad_mode="reflect", eps=1e-9)
        return log_compress(apply_mel(mag, mel_filterbank()))

    x = resample_poly(torch.from_numpy(audio)[None], 48000, IN_SR)
    with torch.inference_mode():
        out = {}
        for name, fn in (("log_mel_f32_stft", log_mel_f32),
                         ("log_mel_f64_stft", mel_encode)):
            out[name] = float((fn(x.cuda()).cpu() - fn(x)).abs().max())
        mel = mel_encode(x)
        out["vocoder_same_mel"] = float(
            (sr_gpu.vocoder(mel.cuda()).cpu() - sr_cpu.vocoder(mel)).abs().max())
    return out


def longform_phase(config, dense_out: np.ndarray, audio10: np.ndarray) -> dict:
    """Phase L (see the module docstring); ``dense_out`` is phase 2's
    default-path output of ``audio10``."""
    import dataclasses

    import torch

    from flowhigh_tpu_torch import (StreamingSR, boundary_lsd,
                                    log_spectral_distance, ops)
    from flowhigh_tpu_torch.dsp import resample_poly
    from flowhigh_tpu_torch.models import mel_encode
    from flowhigh_tpu_torch.profiling import clip_signal, device_profile

    cfg = config.replace(model=dataclasses.replace(config.model,
                                                   attn_flash=True))
    sr = make_sr(cfg, "cuda")  # phase 2's seed: the same weights
    audio = clip_signal(LONG_SECONDS, IN_SR)
    n48 = int(LONG_SECONDS * 48000)
    calls = longform_calls(cfg.vocoder, n48 // cfg.mel.hop_length)

    def run():
        return sr.generate_longform(audio, IN_SR, timestep=1,
                                    vocoder_chunk_frames=CHUNK,
                                    vocoder_overlap_frames=OVERLAP)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase L: {LONG_SECONDS:g} s clip single-pass: out {out.shape} "
          f"finite={bool(np.isfinite(out).all())}, first run {first_s:.2f} s, "
          f"peak device memory {peak / 2 ** 30:.2f} GiB", flush=True)
    if out.shape != (1, n48) or not np.isfinite(out).all():
        raise AssertionError(f"long-form: bad output {out.shape}")
    # one euler step: one vector-field pass, one F launch per layer
    check_launches("phase L: long-form path", counts, calls,
                   flash=cfg.model.depth)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel did not run on the long-form path: "
                             f"{counts}")
    del out
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    clip_ms = float(np.median(times))
    wall_prof, groups, kernels = device_profile(run, 1)
    f_ms = groups.get("kernel F: flash_attn", 0.0)
    voc_ms = sum(ms for g, ms in groups.items()
                 if g.startswith("kernel ") and not g.startswith("kernel F"))
    busy = sum(groups.values())
    print(f"phase L: {clip_ms:.1f} ms per {LONG_SECONDS:g} s clip (median of "
          f"3: {[round(t, 1) for t in times]}), RTF "
          f"{LONG_SECONDS * 1e3 / clip_ms:.1f}; traced: F {f_ms:.1f} ms, "
          f"vocoder kernels A-E {voc_ms:.1f} ms, device busy {busy:.1f} of "
          f"{wall_prof:.1f} ms wall", flush=True)

    # checks on 10 s
    whole = sr.generate(audio10, IN_SR, timestep=1)
    lf = sr.generate_longform(audio10, IN_SR, timestep=1,
                              vocoder_chunk_frames=250,
                              vocoder_overlap_frames=OVERLAP)
    d_lf = float(np.abs(lf - whole).max()) if lf.shape == whole.shape \
        else float("inf")
    x20 = resample_poly(torch.from_numpy(clip_signal(20.0, IN_SR))[None]
                        .cuda(), 48000, IN_SR)
    with torch.inference_mode():
        mel = mel_encode(x20)
        d_voc = float((sr.vocode_chunked(mel) - sr.vocoder(mel)).abs().max())
    d_fd = float(np.abs(whole - dense_out).max())
    print(f"phase L: 10 s: generate_longform (windows of 250 frames) vs "
          f"generate {d_lf:.3e} (<= 2e-4); vocode_chunked vs whole vocoder "
          f"on {mel.shape[1]} frames {d_voc:.3e} (<= 1e-5); flash vs dense "
          f"generate {d_fd:.3e} (<= 1e-3)", flush=True)
    if not (d_lf <= 2e-4 and d_voc <= 1e-5 and d_fd <= 1e-3):
        raise AssertionError(f"long-form 10 s checks failed: {d_lf}, "
                             f"{d_voc}, {d_fd}")

    # StreamingSR on 60 s against the single pass
    audio60 = clip_signal(60.0, IN_SR)
    single = sr.generate_longform(audio60, IN_SR, timestep=1)
    streams = {}
    for wire in ("float32", "int16"):
        st = StreamingSR(sr, chunk_seconds=10.0, overlap_seconds=1.0,
                         wire=wire)
        if wire == "float32":
            st.generate(audio60, IN_SR)  # warm-up: the 10 s chunk shapes
        t0 = time.perf_counter()
        got = st.generate(audio60, IN_SR)
        streams[wire] = (got, time.perf_counter() - t0)
        if got.shape != single.shape or not np.isfinite(got).all():
            raise AssertionError(f"StreamingSR ({wire}): bad output "
                                 f"{got.shape}")
    (f32, wall32), (i16, wall16) = streams["float32"], streams["int16"]
    d_wire = float(np.abs(i16 - f32).max())
    hop_in = int(10.0 * IN_SR) - int(1.0 * IN_SR)
    n_chunks = 1 + -(-(len(audio60) - int(10.0 * IN_SR)) // hop_in)
    boundaries = [c * hop_in * 3 for c in range(1, n_chunks)]
    seam = boundary_lsd(single, f32, boundaries, window=24000)
    overall = float(log_spectral_distance(single, f32)[0])
    print(f"phase L: StreamingSR 60 s ({n_chunks} chunks): RTF "
          f"{60.0 / wall32:.1f} (float32 wire), {60.0 / wall16:.1f} (int16); "
          f"int16 vs float32 {d_wire:.3e} (<= 1e-4); seam LSD {seam:.4f} dB "
          f"vs overall {overall:.4f} dB (bound {max(2.0, 2.5 * overall):.4f})",
          flush=True)
    if not (d_wire <= 1e-4 and seam < max(2.0, 2.5 * overall)
            and np.isfinite(seam) and np.isfinite(overall)):
        raise AssertionError(f"StreamingSR checks failed: {d_wire}, {seam}, "
                             f"{overall}")
    return {"launches": counts, "clip_ms": clip_ms,
            "clip_ms_all": times, "rtf": LONG_SECONDS * 1e3 / clip_ms,
            "first_run_s": first_s, "peak_bytes": peak,
            "traced": {"wall_ms": wall_prof, "device_busy_ms": busy,
                       "flash_ms": f_ms, "vocoder_kernels_ms": voc_ms,
                       "groups_ms": groups, "kernels": kernels[:40]},
            "longform_vs_generate_10s": d_lf,
            "vocode_chunked_vs_whole_2000_frames": d_voc,
            "flash_vs_dense_generate_10s": d_fd,
            "streaming": {"chunks": n_chunks, "rtf_float32": 60.0 / wall32,
                          "rtf_int16": 60.0 / wall16,
                          "int16_vs_float32": d_wire, "seam_lsd_db": seam,
                          "overall_lsd_db": overall}}


SOURCES = {
    "snake_aa": ("flowhigh_tpu_torch/csrc/snake_aa.cu",
                 "flowhigh_tpu/ops/fused_act.py:193, flowhigh_tpu/ops/packed.py:749"),
    "conv1d_same": ("flowhigh_tpu_torch/csrc/conv1d_same.cu",
                    "flowhigh_tpu/ops/packed.py:361 (pallas_packed_conv1d)"),
    "conv_transpose1d": ("flowhigh_tpu_torch/csrc/conv_transpose1d.cu",
                         "flowhigh_tpu/ops/packed.py:361 "
                         "(pallas_packed_conv_transpose1d)"),
    "act_conv1d": ("flowhigh_tpu_torch/csrc/act_conv1d.cu",
                   "flowhigh_tpu/ops/packed.py:1043 (pallas_packed_act_conv1d)"),
    "amp_unit": ("flowhigh_tpu_torch/csrc/amp_unit.cu",
                 "flowhigh_tpu/ops/packed.py:1362 (pallas_packed_amp_unit)"),
    FLASH: ("flowhigh_tpu_torch/csrc/flash_attn.cu",
            "flowhigh_tpu/models/transformer.py:150 (_flash_attention, "
            ":120, the Pallas TPU flash_attention kernel)"),
}
RECORD = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
          "unfused_chain_ms", "max_abs_err", "launches")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "flowhigh_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: flowhigh_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from flowhigh_tpu_torch import FlowHighConfig
    from flowhigh_tpu_torch.ops import _build
    from flowhigh_tpu_torch.profiling import clip_signal

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t_start = time.perf_counter()

    # phase 0: the card and the build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"card: {card}; peaks used for bounds: {peaks[0] / 1e12:g} TFLOP/s "
          f"f32, {peaks[1] / 1e12:g} TB/s", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 0: built {len(libs)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib_name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {lib_name}: {line.strip()}")

    config = FlowHighConfig()
    frames = int(SECONDS * 48000) // config.mel.hop_length
    calls = main_path_calls(config.vocoder, frames)
    calls_unfused = main_path_calls(config.vocoder, frames, False)
    long_frames = int(LONG_SECONDS * 48000) // config.mel.hop_length
    calls_long = longform_calls(config.vocoder, long_frames)

    # phase 1: kernels against plain versions at every shape of the paths
    t0 = time.perf_counter()
    shapes = {k: set(calls[k]) | set(calls_unfused[k]) | set(calls_long[k])
              for k in KERNEL_NAMES}
    rows = check_kernels(shapes, "cuda", peaks)
    main_tot = path_totals(calls, rows)
    unfused_tot = path_totals(calls_unfused, rows)
    print(f"phase 1: {sum(len(v) for v in shapes.values())} vocoder shapes "
          f"checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, r in main_tot.items():
        print(f"  {k}: {r['launches']} launches, {r['ms']:.2f} ms per clip "
              f"(plain {r['plain_ms']:.2f}, bound {r['bound_ms']:.2f} "
              f"{r['bound_by']}, library {r['library_ms']}, unfused chain "
              f"{r['unfused_chain_ms']}), max abs err {r['max_abs_err']:.2e}",
              flush=True)
    t0 = time.perf_counter()
    flash_rows = check_flash(peaks, long_frames)
    print(f"phase 1: flash_attn checked and timed at {len(flash_rows)} shapes "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: full width, 10 s clip, default path then unfused path
    sr = make_sr(config, "cuda")
    audio = clip_signal(SECONDS, IN_SR)
    out, counts = run_main_path(sr, audio, IN_SR)
    torch.cuda.synchronize()
    print(f"phase 2: default path: out {out.shape} "
          f"finite={bool(np.isfinite(out).all())}", flush=True)
    if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    check_launches("phase 2: default path", counts, calls)
    if min(counts[k] for k in KERNEL_NAMES) == 0:
        raise AssertionError(f"a kernel did not run on the main path: {counts}")
    times = clip_ms_of(sr, audio)
    clip_ms = float(np.median(times))
    print(f"phase 2: default path {clip_ms:.2f} ms per 10 s clip (median of "
          f"5: {[round(t, 2) for t in times]}), RTF "
          f"{SECONDS * 1e3 / clip_ms:.1f}", flush=True)

    sr_unf = make_sr(config, "cuda", fuse_act_conv=False)
    out_unf, counts_unf = run_main_path(sr_unf, audio, IN_SR)
    check_launches("phase 2: unfused path", counts_unf, calls_unfused)
    times_unf = clip_ms_of(sr_unf, audio)
    clip_ms_unf = float(np.median(times_unf))
    paths_diff = float(np.abs(out - out_unf).max())
    print(f"phase 2: unfused path {clip_ms_unf:.2f} ms per 10 s clip (median "
          f"of 5: {[round(t, 2) for t in times_unf]}), RTF "
          f"{SECONDS * 1e3 / clip_ms_unf:.1f}; default vs unfused output max "
          f"abs diff {paths_diff:.3e}", flush=True)
    del sr_unf
    if not paths_diff <= 1e-3:
        raise AssertionError(f"default and unfused paths disagree: {paths_diff}")

    # serving phase
    serving = serving_phase(sr)

    # phase 3: 1 s clip, card vs CPU plain path, same weights
    short = clip_signal(1.0, IN_SR)
    out_gpu = sr.generate(short, IN_SR, timestep=1)
    t0 = time.perf_counter()
    sr_cpu = make_sr(config, "cpu")
    out_cpu = sr_cpu.generate(short, IN_SR, timestep=1)
    diff = float(np.abs(out_gpu - out_cpu).max())
    print(f"phase 3: 1 s clip card vs CPU max abs diff {diff:.3e} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    stages = stage_diffs(sr, sr_cpu, short)
    print(f"phase 3: where card and CPU part: {stages}", flush=True)
    del sr, sr_cpu
    if out_gpu.shape != out_cpu.shape or not diff <= 1e-3:
        raise AssertionError(f"card and CPU disagree: {diff}")

    # phase L: long-form, single pass and streamed
    longform = longform_phase(config, out, audio)
    long_tot = path_totals(calls_long, rows)
    r = flash_rows[(1, long_frames, long_frames)]
    n_f = longform["launches"][FLASH]
    long_tot[FLASH] = {
        "launches": n_f,
        "max_abs_err": max(x["max_abs_err"] for x in flash_rows.values()),
        "bound_ms": n_f * max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "ms": n_f * r["ms"], "plain_ms": n_f * r["plain_ms"],
        "library_ms": n_f * r["library_ms"], "unfused_chain_ms": None}

    # phase 4: the records
    kernels = []
    for k in ALL_KERNELS:
        src, replaces = SOURCES[k]
        r = main_tot.get(k, long_tot[k])
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, **{f: r[f] for f in RECORD}}
        if k in unfused_tot:
            entry["unfused_path"] = {f: unfused_tot[k][f] for f in RECORD}
        if k in main_tot:
            entry["longform_path"] = {f: long_tot[k][f] for f in RECORD}
        kernels.append(entry)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "seconds": SECONDS,
        "clip_ms": clip_ms, "clip_ms_all": times,
        "rtf": SECONDS * 1e3 / clip_ms, "clip_ms_unfused": clip_ms_unf,
        "clip_ms_unfused_all": times_unf, "paths_max_abs_diff": paths_diff,
        "serving": serving, "phase3_max_abs_diff": diff,
        "phase3_stages": stages, "launches": counts,
        "launches_unfused": counts_unf, "main_path": main_tot,
        "unfused_path": unfused_tot, "longform": longform,
        "longform_path": long_tot,
        "flash_rows": {str(k): v for k, v in flash_rows.items()},
        "script_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
