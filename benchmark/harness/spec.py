"""What a run reads by name: ``BENCHMARK.json`` at the checkout's root, the
configuration file a cell names, its traffic mix
(``benchmark/traffic/<traffic>.json``) and the reader of each per-layer
metric (``benchmark/metrics/<metric>.py``). A later change adds a cell, a
mix or a metric by adding files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, with "name"
    traffic: dict         # the mix's file, with "name"
    end_to_end: list      # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    config["name"] = w["config"]
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader_module(metric: str):
    """``benchmark/metrics/<metric>.py``: its ``read(ctx)``, the traces it
    ``NEEDS`` and, for a layer's reader, its ``LAYER`` and ``KERNELS``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
