#!/usr/bin/env python3
"""Find the knee of an open-loop serving cell: the highest arrival rate the
program sustains without a growing backlog.

    python3 benchmark/sweep.py --workload serve-poisson16k --seed <n> \\
        --rates 5,6,7,8,9 [--seconds 20]

Sets the cell up once and offers each rate (clips a second, the cell's own
mix otherwise) for ``--seconds``, in turn. For each it prints one JSON
line: clips due and done in the window, done a second, the median and 95th
percentile latency from the due time, the backlog (sent, not yet returned)
at the window's end, and the mean latency of the window's last third over
its first third (a queue that grows reads well above 1). The lines also go
to ``chiprun_out/sweep_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import result, runner, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    runner.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness.drivers.serve_open import Driver
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    drv = Driver(cell, args.seed, "cuda")
    drv.setup()
    out_path = spec.ROOT / "chiprun_out" / f"sweep_{cell.name}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    mix = dict(cell.traffic)
    for rate in [float(r) for r in args.rates.split(",")]:
        drv.mix = {**mix, "rate": rate}
        drv.requests = []
        drv.run_window(args.seconds)
        reqs = drv.requests
        lat = drv.latencies_ms()
        backlog = sum(1 for r in reqs if r.done is None or r.done > drv.t_end)
        third = max(1, len(reqs) // 3)
        early = sum(lat[:third]) / third
        late = sum(lat[-third:]) / third
        line = json.dumps({
            "rate": rate, "due": len(reqs),
            "done_in_window": sum(1 for r in reqs if r.done is not None
                                  and r.done <= drv.t_end),
            "done_per_s": sum(1 for r in reqs if r.done is not None
                              and r.done <= drv.t_end) / args.seconds,
            "p50_ms": result.percentile(lat, 50),
            "p95_ms": result.percentile(lat, 95),
            "backlog_at_end": backlog, "late_over_early": late / early,
            "sender_late_ms": drv.late_ms})
        print(line, flush=True)
        with out_path.open("a") as f:
            f.write(line + "\n")
    drv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
