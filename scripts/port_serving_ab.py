#!/usr/bin/env python3
"""Serving RTF of the port on one CUDA card, for A/B runs.

    python3 scripts/port_serving_ab.py [TREE] [--reps N]

Imports ``flowhigh_tpu_torch`` and ``chip_smoke`` from TREE (default: this
checkout), builds chip_smoke.py's full-width model (``FlowHighConfig()``,
seeded weights, the default vocoder) and runs chip_smoke.py's serving phase
N times (default 3): 12 x 10 s clips through ``ServingPipeline`` with at
most 8 in flight, on the float32 and the int16 wire, each after a warm-up
clip (and its checks: a pinned-seed request and ``generate_batch`` against
``generate``). Prints one JSON line: the tree, the card and each wire's
sustained RTF per run. Run it for two trees in turn, A B B A, in one call,
as ``scripts/port_kernel_ab.py``. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    args = sys.argv[1:]
    reps = 3
    if "--reps" in args:
        i = args.index("--reps")
        reps = int(args[i + 1])
        del args[i:i + 2]
    tree = Path(args[0] if args
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    if not Path(chip_smoke.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {chip_smoke.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("port_serving_ab.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowhigh_tpu_torch import FlowHighConfig
    sr = chip_smoke.make_sr(FlowHighConfig(), "cuda")
    runs = [chip_smoke.serving_phase(sr) for _ in range(reps)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": str(tree), "card": card, "rtf": {
        wire: [r[wire]["rtf"] for r in runs] for wire in ("float32", "int16")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
