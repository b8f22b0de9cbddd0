#!/usr/bin/env python3
"""Build versions of kernel B's source side by side and compare them on one
CUDA card.

    python3 scripts/port_conv_variants.py [NAME=FILE.cu ...]

Compiles ``flowhigh_tpu_torch/csrc/conv1d_same.cu`` (as ``tree``) and each
FILE.cu given (an edited copy of it, under a directory that .gitignore
lists), all at once with the package's nvcc flags, into
``build/conv_variants/``. Prints, per version, the registers and spill
bytes ptxas reports for each instance of the GEMM route (Dot, K, warps
along channels, m16 tiles a warp) and of the narrow route; then, at
resblock shapes of a 10 s clip (C, T, K, d), float32 and bfloat16, one
JSON line per shape: cuDNN's time on the same inputs (TF32 off) and, per
version, [mean ms of 15 launches after 3 warm-ups (CUDA events), within
atol / rtol 1e-4 of F.conv1d on the instance's operands, max abs error].
The versions must keep the C entry points of conv1d_same.cu and the
weight layout of ``ops/conv.py:conv_weight_layout``. Needs nvcc and a CUDA
card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# resblock convs of a 10 s clip: the five stages, K 3 / 7 / 11
SHAPES = [(768, 5000, 11, 5), (768, 5000, 3, 1), (384, 20000, 7, 3),
          (192, 80000, 7, 3), (96, 240000, 3, 5), (96, 240000, 3, 1),
          (48, 480000, 11, 1), (48, 480000, 3, 3)]


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build(versions: dict, out: Path) -> dict:
    """{name: library path} of the versions that compiled; prints ptxas's
    registers and spills of kernel B's GEMM and narrow routes."""
    from flowhigh_tpu_torch.ops import _build
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, src in versions.items():
        cu = out / f"{name}.cu"
        cu.write_text(src.read_text())
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
               str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        libs[name] = out / f"{name}.so"
        for chunk in log.split("Compiling entry function '")[1:]:
            fn = chunk.split("'")[0]
            if "mma" not in fn and "narrow" not in fn:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            inst = re.search(r"DotE(\d)ELi(\d+)ELi(\d)ELi(\d)", fn)
            tag = (f"GEMM Dot {inst.group(1)} K {inst.group(2)} WM "
                   f"{inst.group(3)} MT {inst.group(4)}"
                   if "mma" in fn and inst else f"narrow {fn[-30:]}")
            print(f"  {name} {tag}: {regs and regs.group(1)} registers, "
                  f"spill stores {spill and spill.group(1)} loads "
                  f"{spill and spill.group(2)}", flush=True)
    print(f"built {len(procs)} versions in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    from flowhigh_tpu_torch.ops.conv import conv_weight_layout
    from flowhigh_tpu_torch.ops.quant import round_bf16
    if not torch.cuda.is_available():
        raise SystemExit("port_conv_variants.py needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False

    versions = {"tree": ROOT / "flowhigh_tpu_torch/csrc/conv1d_same.cu"}
    for arg in sys.argv[1:]:
        name, _, path = arg.partition("=")
        versions[name] = Path(path).resolve()
    libs = build(versions, ROOT / "build" / "conv_variants")
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for dt in ("f32", "bf16"):
            fn = getattr(lib, f"conv1d_same_{dt}")
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fns[name, dt] = fn

    gen = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                                * np.float32(scale)).cuda()

    stream = torch.cuda.current_stream().cuda_stream
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for c, t, k, d in SHAPES:
            x, b = randn(1, c, t), randn(c, scale=0.1)
            w = randn(c, c, k, scale=(c * k) ** -0.5)
            pad = d * (k - 1) // 2
            xs, ws = ((round_bf16(x), round_bf16(w)) if dt == torch.bfloat16
                      else (x, w))
            want = F.conv1d(xs, ws, b, padding=pad, dilation=d)
            row = {"cudnn": time_ms(lambda: F.conv1d(
                x.to(dt), w.to(dt), b.to(dt), padding=pad, dilation=d))}
            wl = conv_weight_layout(w, dt)
            for name in libs:
                y = torch.empty_like(want)

                def call(fn=fns[name, dt_name]):
                    return fn(x.data_ptr(), wl.data_ptr(), b.data_ptr(), None,
                              None, None, y.data_ptr(), 1, c, c, t, k, d, 1.0,
                              stream)
                err = call()
                torch.cuda.synchronize()
                diff = (y - want).abs()
                ok = err == 0 and bool(torch.all(diff <= 1e-4
                                                 + 1e-4 * want.abs()))
                row[name] = [time_ms(call), ok, float(diff.max())]
            print(json.dumps({"dtype": dt_name, "shape": [c, t, k, d],
                              **row}), flush=True)
            del x, w, wl, want
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
