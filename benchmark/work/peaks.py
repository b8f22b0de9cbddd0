"""Published dense peaks of the NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet), the card every cell runs on: operations a second of the tensor
cores by input dtype, of the float32 FMA units, and bytes a second of HBM."""

from __future__ import annotations

PEAKS = {"tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12,
         "hbm": 3.35e12}
# a configuration's dot dtype -> the tensor-core peak its products run at
DOT_PEAK = {"float32": "tf32", "bfloat16": "bf16", "int8": "int8"}


def bound_s(work: dict, peaks: dict, dot: str = "float32") -> float:
    """The least time of ``work`` ({"dots", "other", "bytes"}): the larger
    of its operations at the peaks (the dots at the dtype's tensor-core
    peak, the rest at the float32 peak) and its bytes at the HBM peak."""
    compute = (work["dots"] / peaks[DOT_PEAK[dot]]
               + work["other"] / peaks["f32"])
    return max(compute, work["bytes"] / peaks["hbm"])


def add(*works: dict) -> dict:
    out = {"dots": 0.0, "other": 0.0, "bytes": 0.0}
    for w in works:
        for k in out:
            out[k] += w[k]
    return out


def scale(work: dict, n: float) -> dict:
    return {k: v * n for k, v in work.items()}
