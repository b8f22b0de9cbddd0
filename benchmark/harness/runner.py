"""One run of one cell: set-up, the measured window, the traced readings,
the check against the plain reference, and the result.

The cell's mix names its driver (``harness/drivers/<driver>.py``); the
driver builds the program's objects in ``setup``, offers the mix's load in
``run_window(seconds, profiles)``, reports its end-to-end numbers in
``end_to_end()`` and compares what the window produced in ``check()``
after ``free()`` has let the program go.
"""

from __future__ import annotations

import importlib
import os
import sys
import time

from . import readers, result, spec
from .trace import Session, Trace

OUT_DIR = spec.BENCH_DIR / "out"


def set_cache_dirs(root=spec.ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc libraries already live in ``build/flowhigh_tpu_torch``)."""
    cache = root / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def card() -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def _readers(cell) -> dict:
    return {m["name"]: spec.reader_module(m["name"]) for m in cell.per_layer}


def _warm_profiler() -> None:
    """The profiler's first session sets up CUPTI for seconds: pay it in
    set-up, not inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _profilers(cell, needs: set, cuda: bool) -> dict:
    """{"plain": the device alone (the host's operations unrecorded, so
    that the profiler does not slow the host that feeds the device),
    "host": the device and the host's operations} as the readers need
    them, each exporting to ``benchmark/out/<cell>.<kind>.json``."""
    from torch.profiler import ProfilerActivity
    device = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    kinds = {"plain": device,
             "host": [ProfilerActivity.CPU] + device[:int(cuda)]}
    return {k: Session(OUT_DIR / f"{cell.name}.{k}.json", acts)
            for k, acts in kinds.items() if k in needs}


def run(cell, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda") -> tuple[int, dict]:
    """Returns (exit code, the result's fields); ``device`` "cpu" runs the
    program's plain versions (the tests)."""
    import torch
    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    mods = _readers(cell) if trace else {}
    drv = importlib.import_module(
        f"benchmark.harness.drivers.{cell.traffic['driver']}").Driver(
            cell, seed, device)
    print(f"setup: imports and the card {time.perf_counter() - t_process:.3f}"
          " s", file=sys.stderr, flush=True)
    drv.setup()
    for what, sec in getattr(drv, "phases", [])[1:]:
        print(f"setup: {what} {sec:.3f} s", file=sys.stderr, flush=True)
    needs = {n for m in mods.values() for n in getattr(m, "NEEDS", ())}
    if trace and cuda:
        _warm_profiler()
    profiles = _profilers(cell, needs, cuda) if trace else {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drv.run_window(seconds, profiles)
    # to the window's first timed request or step (after a pre-roll)
    setup_s = drv.t_start - t_process
    for session in profiles.values():
        session.export()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev = card() if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(peak)
    metrics, breakdown = {}, None
    if trace:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        traces = {k: Trace(s.path) for k, s in profiles.items() if s.done}
        if "stack" in needs:
            path = OUT_DIR / f"{cell.name}.stack.json"
            drv.stack_pass(path)
            traces["stack"] = Trace(path)
        layers: dict = {}
        kernels: dict = {}
        for m in mods.values():
            if hasattr(m, "LAYER"):
                name, paths = m.LAYER
                layers[name] = tuple(sorted(set(layers.get(name, ())) | set(paths)))
                kernels[name] = tuple(getattr(m, "KERNELS", ()))
        from benchmark.work.peaks import PEAKS
        ctx = readers.Context(drv, traces.get("plain"), traces.get("host"),
                              traces.get("stack"), PEAKS, layers, kernels)
        for m in cell.per_layer:
            value = mods[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        plain = traces.get("plain")
        if plain is not None:
            dev["busy_s"] = plain.busy_s
            dev["window_s"] = plain.window_s
            named = traces.get("host") or plain
            breakdown = {"device_ops": plain.device_ops(),
                         "idle_gaps": named.idle_gaps()}
    else:
        e2e = drv.end_to_end()
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted, failed = drv.counts()
    drv.free()
    correct, checks = drv.check()
    bad = result.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3, {}
    return 0, dict(correct=correct and failed == 0, attempted=attempted,
                   failed=failed, metrics=metrics, device=dev, checks=checks,
                   breakdown=breakdown)
