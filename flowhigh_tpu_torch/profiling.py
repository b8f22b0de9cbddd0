"""Device-time breakdown of one ``FlowHighSR.generate`` on the card.

    python -m flowhigh_tpu_torch.profiling [--unfused]

Runs the main path at full width (``FlowHighConfig()``, seeded weights,
``independent_cfm_adaptive``, euler, 1 step; the default fused vocoder, or
``fuse_act_conv=False`` with ``--unfused``) on a 10 s, 16 kHz clip, three
times under ``torch.profiler`` after one warm-up run, and prints one JSON
object: the
card, wall ms per clip, device-busy ms per clip (the sum of kernel times on
the one stream), the idle share (1 - busy / wall) and device ms per kernel
group, largest first. The full per-kernel table goes to
``chiprun_out/profile_generate.json`` (``profile_generate_unfused.json``).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import FlowHighConfig, FlowHighSR

SECONDS, REPS = 10.0, 3

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("flash_attn", "kernel F: flash_attn"),
    ("snake_aa", "kernel A: snake_aa"),
    ("act_conv1d", "kernel D: act_conv1d"),  # before conv1d_mma (B)
    ("amp_unit", "kernel E: amp_unit"),
    ("conv1d_mma", "kernel B: conv1d_same"),
    ("conv1d_narrow", "kernel B: conv1d_same"),
    ("conv1d_int8", "kernel B: conv1d_same"),
    ("conv_transpose1d_kernel", "kernel C: conv_transpose1d"),
    ("fft", "cuFFT (STFT/iSTFT)"),
    ("fprop", "cuDNN conv (resample, conv_pre, pos-embed)"),
    ("conv", "cuDNN conv (resample, conv_pre, pos-embed)"),
    ("gemm", "matmul (vector field, mel, attention)"),
)


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other (elementwise, reductions, copies)"


def _self_device_us(evt) -> float:
    """Device time of a device-side event (kernel, memcpy, memset); 0 for
    host-side operator events, whose device time is their kernels'."""
    if "CUDA" not in str(getattr(evt, "device_type", "")):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_profile(fn, reps: int) -> tuple[float, dict, list]:
    """Run ``fn`` ``reps`` times under ``torch.profiler`` (the caller warms
    it up first): (wall ms per run, {kernel group: device ms per run},
    per-kernel rows largest first)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps

    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us <= 0:
            continue
        ms = us / 1e3 / reps
        kernels.append({"name": evt.key, "ms_per_clip": ms,
                        "calls_per_clip": evt.count / reps})
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + ms
    kernels.sort(key=lambda k: -k["ms_per_clip"])
    return wall_ms, dict(sorted(groups.items(), key=lambda kv: -kv[1])), kernels


def clip_signal(seconds: float, sr: int) -> np.ndarray:
    """bench.py's test signal: two tones + a little noise, seed 0."""
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)
            + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    unfused = "--unfused" in (sys.argv[1:] if argv is None else argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sr = FlowHighSR(FlowHighConfig(), cfm_method="independent_cfm_adaptive",
                    ode_method="euler", fuse_act_conv=not unfused,
                    device="cuda")
    sr.init_params(0)
    audio = clip_signal(SECONDS, 16000)
    sr.generate(audio, 16000)  # warm-up: kernel build, cuFFT plans, cuDNN
    torch.cuda.synchronize()

    wall_ms, groups, kernels = device_profile(
        lambda: sr.generate(audio, 16000), REPS)
    busy_ms = sum(groups.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    result = {
        "card": card, "fuse_act_conv": not unfused, "seconds": SECONDS,
        "reps": REPS,
        "wall_ms_per_clip": wall_ms, "device_busy_ms_per_clip": busy_ms,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "groups_ms_per_clip": groups,
    }
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "profile_generate_unfused.json" if unfused else "profile_generate.json"
    (out_dir / name).write_text(
        json.dumps({**result, "kernels": kernels}, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
