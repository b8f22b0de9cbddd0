#!/usr/bin/env python3
"""The anti-aliased activation's probes on one CUDA card: the port's
counterpart of scripts/bench_act_mxu.py (which runs on a TPU).

    python3 scripts/port_bench_act_mxu.py [--reps 15] [--warmup 3]

For each of the JAX script's four stage shapes (S rows of L = p * C lanes;
the port has no packing, so p only sets the width) it times, with CUDA
events (median of ``--reps`` single launches after ``--warmup``):

    act_full     kernel A (ops.snake_activation1d) on the same elements
                 as [1, C, S * p]
    firs_only    kernel A's firs-only instance (ops.act_firs_only): the
                 FIRs without the snake
    snake_floor  kernel G (ops.snake_only) on [1, S, L]: the snake alone on
                 2x the elements, A's arithmetic floor
    conv k7d3    kernel B (ops.conv1d, k 7, d 3) on [1, C, S * p], with its
                 TFLOP/s
    mxu_fir      kernel H (ops.mxu_fir) for p > 1, as the JAX script: f32,
                 f32 dots_only and bf16 (mma.sync), and bf16 dots_only

Each row carries its bound: the larger of the bytes it must move over the
card's memory rate and its operations over the card's peak for their type
(chip_smoke.py's table). The inputs are the JAX script's, made with numpy
from the same seed in the same order. The TPU's ``cap`` variants are not
run: the tile rows are the card's own. One JSON line per case. Without a
CUDA card it exits with a message and runs nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # flowhigh_tpu_torch and chip_smoke's tables

# (name, S, C, p) of scripts/bench_act_mxu.py
CASES = [
    ("s5 p=8 c=48", 60000, 48, 8),
    ("s4 p=4 c=96", 60000, 96, 4),
    ("s3 p=2 c=192", 40000, 192, 2),
    ("s2 p=1 c=384", 20000, 384, 1),
]
FIRS_OPS = 48.0  # per sample: 12 up and 12 down multiply-adds
# the JAX script's f32, f32 dots_only and bf16 rows, and bf16 dots_only:
# every instance of H
MXU_VARIANTS = (("f32", "float32", True), ("f32 dots_only", "float32", False),
                ("bf16", "bfloat16", True), ("bf16 dots_only", "bfloat16", False))


def case_inputs(rng: np.random.Generator, s: int, c: int, p: int,
                device) -> dict:
    """The JAX script's inputs of one case, drawn from ``rng`` in its order
    (x, log-alpha, log-beta, the conv's w and b, then for p > 1 the FIR
    matrices), as torch tensors on ``device``: x [1, S, L] and its unpacked
    [1, C, S * p] view, ab [2, L], ab2 [2, 2L], the conv in PyTorch's
    layout, up / dn in float32 and bfloat16."""
    import torch
    pc = p * c

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x = rng.standard_normal((1, s, pc)).astype(np.float32) * 0.3
    al = rng.standard_normal(c).astype(np.float32) * 0.1
    be = rng.standard_normal(c).astype(np.float32) * 0.1
    ab = np.stack([np.tile(np.exp(al), p),
                   np.tile(np.exp(be), p)]).astype(np.float32)
    w = rng.standard_normal((7, c, c)).astype(np.float32) * 0.05
    b = rng.standard_normal(c).astype(np.float32) * 0.02
    out = {"x": t(x), "al": t(al), "be": t(be), "ab": t(ab),
           "ab2": t(np.concatenate([ab, ab], axis=1)),
           # packed [S, p * C] (lane = phase * C + channel) -> [C, S * p]
           "x_act": t(x.reshape(1, s, p, c).transpose(0, 3, 1, 2)
                      .reshape(1, c, s * p)),
           "w": t(w.transpose(2, 1, 0)), "b": t(b)}  # [K, Cin, Cout] -> [Cout, Cin, K]
    if p > 1:
        up = t(rng.standard_normal((3, pc, 2 * pc)).astype(np.float32))
        dn = t(rng.standard_normal((3, 2 * pc, pc)).astype(np.float32))
        out.update(up=up, dn=dn, up_bf16=up.to(torch.bfloat16),
                   dn_bf16=dn.to(torch.bfloat16))
    return out


def bound(byt: float, dot_ops: float, other_ops: float, peaks,
          dot_peak: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take."""
    bytes_ms = byt / peaks[1] * 1e3
    ops_ms = (dot_ops / dot_peak + other_ops / peaks[0]) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def case_rows(inp: dict, s: int, c: int, p: int, peaks) -> dict:
    """{row: (kernel call, plain call, bound ms, bound_by)} of one case."""
    from chip_smoke import work
    from flowhigh_tpu_torch import ops

    lanes, t = p * c, s * p
    x, xa = inp["x"], inp["x_act"]
    rows = {}
    byt, _, other = work("snake_aa", (c, t))
    rows["act_full"] = (
        lambda: ops.snake_activation1d(xa, inp["al"], inp["be"], True),
        lambda: ops.snake_activation1d_plain(xa, inp["al"], inp["be"], True),
        *bound(byt, 0.0, other, peaks, peaks[0]))
    rows["firs_only"] = (lambda: ops.act_firs_only(xa),
                         lambda: ops.act_firs_only_plain(xa),
                         *bound(4.0 * (2 * c * t + 12), 0.0, FIRS_OPS * c * t,
                                peaks, peaks[0]))
    rows["snake_floor"] = (lambda: ops.snake_only(x, inp["ab"]),
                           lambda: ops.snake_only_plain(x, inp["ab"]),
                           *bound(4.0 * (2 * s * lanes + 2 * lanes), 0.0,
                                  0.0, peaks, peaks[0]))
    byt, dots, other = work("conv1d_same", (c, c, t, 7, 3, 0, 1.0))
    rows["conv k7d3"] = (
        lambda: ops.conv1d(xa, inp["w"], inp["b"], dilation=3),
        lambda: ops.conv1d_plain(xa, inp["w"], inp["b"], dilation=3),
        *bound(byt, dots, other, peaks, peaks[0]))
    if p == 1:
        return rows  # shifts are free row slices at p = 1 (the JAX script)
    for label, dt, snk in MXU_VARIANTS:
        sfx = "_bf16" if dt == "bfloat16" else ""
        up, dn = inp["up" + sfx], inp["dn" + sfx]
        size = up.element_size()
        rows[f"mxu_fir {label}"] = (
            lambda up=up, dn=dn, snk=snk: ops.mxu_fir(x, up, dn, inp["ab2"],
                                                      do_snake=snk),
            lambda up=up, dn=dn, snk=snk: ops.mxu_fir_plain(
                x, up, dn, inp["ab2"], do_snake=snk),
            *bound(4.0 * (2 * s * lanes + 4 * lanes) + size * 12 * lanes ** 2,
                   24.0 * s * lanes ** 2, 0.0, peaks,
                   peaks[2] if dt == "bfloat16" else peaks[0]))
    return rows


def run(reps: int = 15, warmup: int = 3, emit=print) -> list:
    """Time every row of every case on the card; ``emit`` gets each human
    line and each case's JSON line. Returns the per-case records."""
    import torch
    from chip_smoke import card_peaks, time_ms

    peaks = card_peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(0)
    records = []
    for name, s, c, p in CASES:
        inp = case_inputs(rng, s, c, p, "cuda")
        rows = case_rows(inp, s, c, p, peaks)
        rec = {"case": name, "S": s, "C": c, "p": p, "rows": {}}
        for row, (fn, _, bound_ms, bound_by) in rows.items():
            ms = time_ms(fn, reps, warmup)
            rec["rows"][row] = {"ms": ms, "bound_ms": bound_ms,
                                "bound_by": bound_by}
        conv = rec["rows"]["conv k7d3"]
        conv["tflops"] = 2.0 * s * p * c * c * 7 / (conv["ms"] * 1e-3) / 1e12
        act = rec["rows"]["act_full"]["ms"]
        emit(f"{name}: " + ", ".join(
            f"{row} {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
            f"{r['bound_by']}" + (f", {act - r['ms']:+.3f} vs act"
                                  if row.startswith("mxu") else "") + ")"
            for row, r in rec["rows"].items())
            + f"; conv {conv['tflops']:.1f} TFLOP/s")
        emit(json.dumps(rec))
        records.append(rec)
        del inp, rows
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_bench_act_mxu: needs a CUDA card; nothing was run",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0] if card else 'unknown'}", flush=True)
    run(args.reps, args.warmup, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
