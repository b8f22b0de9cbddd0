#!/usr/bin/env python3
"""Smoke run of flowhigh_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. print the card (nvidia-smi name, power limit) and build the CUDA kernels
   from flowhigh_tpu_torch/csrc with nvcc (all sources in parallel);
1. hold every kernel against its plain PyTorch version on the card at every
   shape a 10 s, 16 kHz clip gives it on both vocoder paths, the default
   (``fuse_act_conv=True``: kernels A-E) and the unfused one
   (``fuse_act_conv=False``: A, B, C), atol 1e-4, rtol 1e-4; time the
   kernel, the plain version and the one PyTorch library call that computes
   the same function where there is one (CUDA events, median of 15 after 3
   warm-up launches). No single PyTorch call computes kernel D or E; their
   yardstick is the port's own unfused chain of kernels A and B for the same
   work (``unfused_chain_ms``);
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
4. print the ``kernels`` JSON line (per kernel: the default path's launches
   and the per-clip sums over them; the unfused path's in ``unfused_path``),
   the card line and, last, the ``ok`` line.

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
                "amp_unit")


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
    return {k: fn.launches for k, fn in zip(KERNEL_NAMES, ops.KERNELS)}


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


def check_launches(what: str, counts: dict, calls: dict) -> None:
    expected = {k: sum(calls[k].values()) for k in KERNEL_NAMES}
    print(f"phase 2: {what}: launches {counts} (expected {expected})",
          flush=True)
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

    # phase 1: kernels against plain versions at every shape of both paths
    t0 = time.perf_counter()
    shapes = {k: set(calls[k]) | set(calls_unfused[k]) for k in KERNEL_NAMES}
    rows = check_kernels(shapes, "cuda", peaks)
    main_tot = path_totals(calls, rows)
    unfused_tot = path_totals(calls_unfused, rows)
    print(f"phase 1: {sum(len(v) for v in shapes.values())} shapes checked "
          f"and timed in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, r in main_tot.items():
        print(f"  {k}: {r['launches']} launches, {r['ms']:.2f} ms per clip "
              f"(plain {r['plain_ms']:.2f}, bound {r['bound_ms']:.2f} "
              f"{r['bound_by']}, library {r['library_ms']}, unfused chain "
              f"{r['unfused_chain_ms']}), max abs err {r['max_abs_err']:.2e}",
              flush=True)

    # phase 2: full width, 10 s clip, default path then unfused path
    sr = make_sr(config, "cuda")
    audio = clip_signal(SECONDS, IN_SR)
    out, counts = run_main_path(sr, audio, IN_SR)
    torch.cuda.synchronize()
    print(f"phase 2: default path: out {out.shape} "
          f"finite={bool(np.isfinite(out).all())}", flush=True)
    if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    check_launches("default path", counts, calls)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel did not run on the main path: {counts}")
    times = clip_ms_of(sr, audio)
    clip_ms = float(np.median(times))
    print(f"phase 2: default path {clip_ms:.2f} ms per 10 s clip (median of "
          f"5: {[round(t, 2) for t in times]}), RTF "
          f"{SECONDS * 1e3 / clip_ms:.1f}", flush=True)

    sr_unf = make_sr(config, "cuda", fuse_act_conv=False)
    out_unf, counts_unf = run_main_path(sr_unf, audio, IN_SR)
    check_launches("unfused path", counts_unf, calls_unfused)
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

    # phase 4: the records
    kernels = []
    for k in KERNEL_NAMES:
        src, replaces = SOURCES[k]
        r = main_tot[k]
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, **{f: r[f] for f in RECORD}}
        if k in unfused_tot:
            entry["unfused_path"] = {f: unfused_tot[k][f] for f in RECORD}
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
        "unfused_path": unfused_tot,
        "script_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
