#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the chip, at the cell's
own sizes: the program's checked numbers on each of ``--seeds``, and on
each of ``--control-seeds`` the control's (the plain reference computed one
precision below the configuration's, put in the program's place) and, for
a training cell, the planted faults' (half of each batch left out, the
mean taken over the rest; for the GAN also both rates 1.25 times the
configuration's).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 6]

A serving cell runs a short window (``--seconds``) at its own load per
seed and compares the same sample of results a run compares; a training
cell runs set-up's first steps. One JSON line per seed on standard output,
and the lot in ``chiprun_out/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import compare, runner, spec  # noqa: E402


def serving(drv, seconds: float, control: bool) -> dict:
    from benchmark.harness.serving import gap
    from benchmark.reference import precision
    drv.run_window(seconds)
    reqs = drv.sample()
    drv.free()
    ref = drv.reference_outputs(reqs)
    out = {"program": {"wave_rel_l2": max(
        gap(r.out[0], c) for r, c in zip(reqs, ref))}, "clips": len(reqs)}
    if control:
        ctl = drv.reference_outputs(reqs, control=precision.tf32)
        out["control"] = {"wave_rel_l2": max(
            gap(o[0], c) for o, c in zip(ctl, ref))}
    return out


def training(drv, control: bool, kind: str) -> dict:
    from benchmark.reference import precision
    n = int(drv.mix["check_steps"])
    numbers = importlib.import_module(type(drv).__module__).numbers
    drv.free()
    with precision.full_f32():
        ref = drv.reference(n)
        out = {"program": numbers(drv.first, ref),
               "details": compare.details(drv.first, ref)}
        if control:
            half = slice(0, int(drv.mix["batch"]) // 2)
            fault = drv.reference(n, rows=half)
            out["fault_half_batch"] = numbers(fault, ref)
            out["fault_details"] = compare.details(fault, ref)
            if kind == "gan_steps":
                fault = drv.reference(n, lr_scale=1.25)
                out["fault_lr"] = numbers(fault, ref)
                out["fault_lr_details"] = compare.details(fault, ref)
            if kind == "field_steps":  # bf16 training: the fp8 control
                ctl = drv.reference(n, quant=precision.fp8)
    if control and kind == "gan_steps":  # float32: the TF32 control
        with precision.tf32():
            ctl = drv.reference(n)
    if control:
        out["control"] = numbers(ctl, ref)
        out["control_details"] = compare.details(ctl, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    runner.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    kind = cell.traffic["driver"]
    driver = importlib.import_module(f"benchmark.harness.drivers.{kind}").Driver
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out_path = spec.ROOT / "chiprun_out" / f"calibrate_{cell.name}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = driver(cell, seed, "cuda")
        drv.setup()
        if kind.startswith("serve"):
            res = serving(drv, args.seconds, seed in controls)
        else:
            res = training(drv, seed in controls, kind)
        res.update(seed=seed, seconds=time.perf_counter() - t0)
        line = json.dumps(res)
        print(line, flush=True)
        with out_path.open("a") as f:
            f.write(line + "\n")
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
