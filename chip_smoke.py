#!/usr/bin/env python3
"""Smoke run of flowhigh_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. print the card (nvidia-smi name, power limit) and build the CUDA kernels
   from flowhigh_tpu_torch/csrc with nvcc (all sources in parallel);
1. hold every kernel against its plain PyTorch version on the card at every
   shape a 10 s, 16 kHz clip gives it (atol 1e-4, rtol 1e-4), and time the
   kernel, the plain version and the one PyTorch library call that computes
   the same function (CUDA events, median of 15 after 3 warm-up launches);
2. run FlowHighSR.generate at full width (FlowHighConfig() defaults, seeded
   random weights) on a 10 s, 16 kHz clip: launch counts of the kernels on
   that run, output shape and finiteness, median ms per clip and RTF;
3. run a 1 s clip through the same weights on the card and on the CPU
   (plain versions): max abs waveform difference <= 1e-3; also report the
   card-vs-CPU difference of the log-mel (float32 and float64 STFT) and of
   the vocoder alone on one mel;
4. print the ``kernels`` JSON line, the card line and, last, the ``ok`` line.

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

def main_path_calls(cfg, frames: int):
    """Every kernel call of one BigVGAN forward over ``frames`` mel frames:
    {kernel: {shape key: launches}}. Keys: snake (C, T); conv
    (Cin, Cout, T, K, d, n_res, out_scale); convt (Cin, Cout, T_in, u, K)."""
    calls = {"snake_aa": {}, "conv1d_same": {}, "conv_transpose1d": {}}

    def add(kernel, key, n=1):
        calls[kernel][key] = calls[kernel].get(key, 0) + n

    ch, t = cfg.upsample_initial_channel, frames
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout = cfg.upsample_initial_channel // 2 ** (i + 1)
        add("conv_transpose1d", (ch, cout, t, u, k))
        ch, t = cout, t * u
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for m, d in enumerate(rd):
                add("snake_aa", (ch, t), 2)
                add("conv1d_same", (ch, ch, t, rk, d, 0, 1.0))
                last = j == nk - 1 and m == len(rd) - 1
                add("conv1d_same", (ch, ch, t, rk, 1, nk if last else 1,
                                    1.0 / nk if last else 1.0))
    add("snake_aa", (ch, t))
    add("conv1d_same", (ch, 1, t, 7, 1, 0, 1.0))
    return calls


def work(kernel: str, key) -> tuple[float, float]:
    """(bytes moved: each input read once, each output written once;
    operations) of one call."""
    if kernel == "snake_aa":
        c, t = key
        # 2 x 6 up taps, snake (mul, sin, mul, fma) on 2 samples, 12 down
        # taps: 2*12 + 2*4 + 2*12 operations per output sample
        return 4.0 * (2 * c * t + 2 * c + 12), 56.0 * c * t
    if kernel == "conv1d_same":
        cin, cout, t, k, _, n_res, _ = key
        byt = 4.0 * (cin * t + cout * cin * k + cout + (n_res + 1) * cout * t)
        return byt, 2.0 * cin * cout * k * t + (n_res + 2.0) * cout * t
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


def check_kernels(calls: dict, device, peaks) -> dict:
    """Phase 1: each kernel against its plain version at every shape of
    ``calls``; returns per-kernel results (per-clip sums over launches)."""
    import torch
    import torch.nn.functional as F

    from flowhigh_tpu_torch.ops import (conv1d, conv1d_plain, conv_transpose1d,
                                        conv_transpose1d_plain,
                                        snake_activation1d,
                                        snake_activation1d_plain)
    from flowhigh_tpu_torch.utils import cudnn_f32

    flops, bw = peaks
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(device)

    results = {}
    for kernel, keys in calls.items():
        rows = []
        for key, n in keys.items():
            if kernel == "snake_aa":
                c, t = key
                x = randn(1, c, t)
                a, b = randn(c, scale=0.3), randn(c, scale=0.3)
                run = lambda: snake_activation1d(x, a, b, True)
                plain = lambda: snake_activation1d_plain(x, a, b, True)
                lib = None
            elif kernel == "conv1d_same":
                cin, cout, t, k, d, n_res, scale = key
                x = randn(1, cin, t)
                w = randn(cout, cin, k, scale=(cin * k) ** -0.5)
                b = randn(cout, scale=0.1)
                res = tuple(randn(1, cout, t) for _ in range(n_res))
                run = lambda: conv1d(x, w, b, dilation=d, residuals=res,
                                     out_scale=scale)
                plain = lambda: conv1d_plain(x, w, b, dilation=d,
                                             residuals=res, out_scale=scale)

                def lib():
                    with cudnn_f32():
                        return F.conv1d(x, w, b, padding=d * (k - 1) // 2,
                                        dilation=d)
            else:
                cin, cout, t, u, k = key
                x = randn(1, cin, t)
                w = randn(cin, cout, k, scale=(cout * k) ** -0.5)
                b = randn(cout, scale=0.1)
                run = lambda: conv_transpose1d(x, w, b, stride=u)
                plain = lambda: conv_transpose1d_plain(x, w, b, stride=u)

                def lib():
                    with cudnn_f32():
                        return F.conv_transpose1d(x, w, b, stride=u,
                                                  padding=(k - u) // 2)
            max_abs, max_rel = _compare(kernel, key, run(), plain())
            byt, ops = work(kernel, key)
            row = {"key": list(key), "launches": n, "max_abs_err": max_abs,
                   "max_rel_err": max_rel, "bytes": byt, "ops": ops,
                   "bytes_ms": byt / bw * 1e3, "ops_ms": ops / flops * 1e3}
            row["ms"] = time_ms(run)
            row["plain_ms"] = time_ms(plain)
            row["library_ms"] = time_ms(lib) if lib is not None else None
            rows.append(row)
            del x
        tot = lambda f: sum(r["launches"] * r[f] for r in rows)
        bytes_ms, ops_ms = tot("bytes_ms"), tot("ops_ms")
        results[kernel] = {
            "rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bound_ms": sum(r["launches"] * max(r["bytes_ms"], r["ops_ms"])
                            for r in rows),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ms": tot("ms"),
            "plain_ms": tot("plain_ms"),
            "library_ms": (None if rows[0]["library_ms"] is None
                           else tot("library_ms")),
        }
    return results


# --- end to end ----------------------------------------------------------------

def make_sr(config, device: str, seed: int = 0):
    from flowhigh_tpu_torch import FlowHighSR
    sr = FlowHighSR(config, cfm_method="independent_cfm_adaptive",
                    ode_method="euler", device=device)
    sr.init_params(seed)
    return sr


def run_main_path(sr, audio: np.ndarray, in_sr: int) -> tuple[np.ndarray, dict]:
    """One generate with every launch count zeroed just before and read just
    after."""
    from flowhigh_tpu_torch import ops
    ops.reset_launch_counts()
    out = sr.generate(audio, in_sr, timestep=1)
    counts = {"snake_aa": ops.snake_activation1d.launches,
              "conv1d_same": ops.conv1d.launches,
              "conv_transpose1d": ops.conv_transpose1d.launches}
    return out, counts


def stage_diffs(sr_gpu, sr_cpu, audio: np.ndarray) -> dict:
    """Max abs card-vs-CPU differences of the pieces of one clip: the
    log-mel with its STFT in float32 and in float64 (the encode's), and the
    vocoder alone on one mel (all 187 kernel launches against the plain
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
}


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

    # phase 1: kernels against plain versions at every main-path shape
    t0 = time.perf_counter()
    results = check_kernels(calls, "cuda", peaks)
    print(f"phase 1: {sum(len(v) for v in calls.values())} shapes checked and "
          f"timed in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: full width, 10 s clip
    sr = make_sr(config, "cuda")
    audio = clip_signal(SECONDS, IN_SR)
    out, counts = run_main_path(sr, audio, IN_SR)
    torch.cuda.synchronize()
    expected = {k: sum(v.values()) for k, v in calls.items()}
    print(f"phase 2: launches {counts} (expected {expected}); "
          f"out {out.shape} finite={bool(np.isfinite(out).all())}", flush=True)
    if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    for k, n in expected.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches on the main path, "
                                 f"expected {n}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr.generate(audio, IN_SR, timestep=1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    clip_ms = float(np.median(times))
    print(f"phase 2: {clip_ms:.2f} ms per 10 s clip (median of 5: "
          f"{[round(t, 2) for t in times]}), RTF {SECONDS * 1e3 / clip_ms:.1f}",
          flush=True)

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
    for k, r in results.items():
        src, replaces = SOURCES[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "clip_ms": clip_ms,
        "clip_ms_all": times, "rtf": SECONDS * 1e3 / clip_ms,
        "phase3_max_abs_diff": diff, "phase3_stages": stages,
        "launches": counts,
        "kernels": {k: {kk: vv for kk, vv in r.items()}
                    for k, r in results.items()}}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
