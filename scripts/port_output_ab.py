#!/usr/bin/env python3
"""Compare the port's output across two trees on one CUDA card.

    python3 scripts/port_output_ab.py [--unfused] [--dtype DT] TREE OUT.npy
                                      [REF.npy]

Imports ``flowhigh_tpu_torch`` from TREE, runs ``FlowHighSR.generate`` at
full width (``FlowHighConfig()``, seeded weights ``init_params(0)``,
``independent_cfm_adaptive``, euler, 1 step, the default vocoder, or with
``--unfused`` ``fuse_act_conv=False``: kernels A, B, C; ``--dtype``
float32 (the default), bfloat16 or int8 sets ``vocoder_conv_dtype``) on the
10 s, 16 kHz test signal of ``profiling.clip_signal``, saves the 48 kHz
output to OUT.npy and prints one JSON line: the tree, the card, the
output's shape, and with REF.npy the max abs difference against it. Run it
for the parent's tree (unpacked into a directory that .gitignore lists,
``build/...``) and then for this one with the parent's output as REF.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np


DTYPES = ("float32", "bfloat16", "int8")


def main() -> int:
    args = sys.argv[1:]
    unfused = "--unfused" in args
    args = [a for a in args if a != "--unfused"]
    dtype = "float32"
    if "--dtype" in args:
        i = args.index("--dtype")
        dtype = args[i + 1] if i + 1 < len(args) else ""
        del args[i:i + 2]
    if len(args) not in (2, 3) or dtype not in DTYPES:
        raise SystemExit(__doc__)
    tree = Path(args[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import flowhigh_tpu_torch
    from flowhigh_tpu_torch import FlowHighConfig, FlowHighSR
    from flowhigh_tpu_torch.profiling import clip_signal
    if not Path(flowhigh_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {flowhigh_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("port_output_ab.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sr = FlowHighSR(FlowHighConfig(), cfm_method="independent_cfm_adaptive",
                    ode_method="euler", fuse_act_conv=not unfused,
                    device="cuda",
                    vocoder_conv_dtype=None if dtype == "float32" else dtype)
    sr.init_params(0)
    out = sr.generate(clip_signal(10.0, 16000), 16000, timestep=1)
    np.save(args[1], out)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"tree": str(tree), "card": card, "unfused": unfused,
           "dtype": dtype,
           "shape": list(out.shape),
           "finite": bool(np.isfinite(out).all())}
    if len(args) == 3:
        ref = np.load(args[2])
        res["max_abs_diff_vs_ref"] = (float(np.abs(out - ref).max())
                                      if ref.shape == out.shape else None)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
