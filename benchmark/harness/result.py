"""The run's last lines: the checked numbers beside their limits (standard
error), and one JSON object (standard output)."""

from __future__ import annotations

import json
import math
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "flowhigh_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics; ``inf`` entries (missing answers) sort last."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if v[hi] == math.inf:
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def line(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown=None) -> str:
    """The result object; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def emit(correct, attempted, failed, metrics, device, checks,
         breakdown=None) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(line(correct, attempted, failed, metrics, device, checks,
               breakdown), flush=True)
