#!/usr/bin/env python3
"""The benchmark of flowhigh_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and the cell's files under
``benchmark/``, sets the program up (weights and inputs from ``--seed``,
every shape of the cell warmed), measures for ``--seconds``, checks the
window's results against the plain reference and prints one JSON object as
its last line of standard output (``--trace 1``: the per-layer metrics from
a profiled part of the window, ``--trace 0``: the end-to-end metrics). It
exits non-zero, printing no result, without the CUDA cards the cell asks
for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import result, runner, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    runner.set_cache_dirs()
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    code, out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                           T_PROCESS)
    if code:
        return code
    result.emit(**out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
