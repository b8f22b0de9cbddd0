"""The trace reader on a hand-made Chrome trace: busy time as a union over
overlapping streams, operations tied to their launches' host ranges and
Python stacks, idle gaps named by the host's operation."""

import json

from benchmark.harness.trace import Trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _trace(tmp_path):
    events = [
        # host thread 1: a forward op, then the autograd engine's range
        _x("cpu_op", "aten::mm", 0, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 20, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _x("cpu_op", "Optimizer.step#Adam.step", 60, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        _x("cpu_op", "aten::copy_", 100, 60),
        _x("cuda_runtime", "cudaLaunchKernel", 158, 1, correlation=4),
        # Python frames on thread 1 around launches 1 and 4
        _x("python_function", "flowhigh_tpu_torch/models/bigvgan.py(9): forward", 0, 12),
        _x("python_function", "flowhigh_tpu_torch/ops/conv.py(5): conv1d", 1, 5),
        _x("python_function", "flowhigh_tpu_torch/dsp/stft.py(3): stft", 150, 10),
        # device: kernels 1 and 2 overlap on two streams
        _x("kernel", "k1", 5, 20, tid=7, correlation=1),
        _x("kernel", "k2", 15, 20, tid=8, correlation=2),
        _x("kernel", "adam", 65, 5, tid=7, correlation=3),
        _x("kernel", "stft_kernel", 160, 10, tid=7, correlation=4),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(path)


def test_busy_is_a_union_and_the_window_spans_the_device(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == (170 - 5) / 1e6
    assert t.busy_s == (30 + 5 + 10) / 1e6
    assert t.launches() == 4
    assert t.device_ops(2) == [["k1", 20e-6], ["k2", 20e-6]]


def test_operations_under_host_ranges(tmp_path):
    t = _trace(tmp_path)
    assert [e["name"] for e in t.under("autograd::engine")] == ["k2"]
    assert [e["name"] for e in t.under("Optimizer.step#")] == ["adam"]


def test_layers_by_the_innermost_named_frame(tmp_path):
    t = _trace(tmp_path)
    by = t.by_layer({"vocoder": ("flowhigh_tpu_torch/models/bigvgan.py",),
                     "dsp": ("flowhigh_tpu_torch/dsp/",)})
    assert [e["name"] for e in by["vocoder"]] == ["k1"]
    assert [e["name"] for e in by["dsp"]] == ["stft_kernel"]
    assert [e["name"] for e in by[None]] == ["k2", "adam"]


def test_idle_gaps_are_named_by_the_host(tmp_path):
    t = _trace(tmp_path)
    gaps = dict(t.idle_gaps())
    # 35..65 (the next launch at 61 inside the optimizer's step, which the
    # gap's middle, 50, precedes: the backward's range covers it), 70..160
    assert gaps["autograd::engine::evaluate_function: MmBackward0"] == 30e-6
    assert gaps["aten::copy_"] == 90e-6


def test_layer_times_come_from_the_window_split_as_the_pass_splits_them(
        tmp_path):
    """The attribution pass maps kernels to layers (a kernel that two layers
    launch is split by its time there); the window's profile gives the
    times, over the input seconds its span stands for."""
    from types import SimpleNamespace

    from benchmark.harness import readers
    voc = "flowhigh_tpu_torch/models/bigvgan.py(9): forward"
    dsp = "flowhigh_tpu_torch/dsp/stft.py(3): stft"
    stack = [
        _x("python_function", voc, 0, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
        _x("python_function", dsp, 50, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        _x("kernel", "amp_unit", 2, 5, tid=7, correlation=1),
        _x("kernel", "ew", 11, 3, tid=7, correlation=2),
        _x("kernel", "ew", 52, 1, tid=7, correlation=3),
    ]
    window = [_x("kernel", "amp_unit", 0, 600, tid=7),
              _x("kernel", "ew", 600, 400, tid=7),
              _x("kernel", "unseen", 1000, 1000, tid=7)]
    traces = {}
    for name, events in (("stack", stack), ("plain", window)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"traceEvents": events}))
        traces[name] = Trace(path)
    ctx = readers.Context(
        SimpleNamespace(audio_rate=lambda: 5.0), traces["plain"],
        None, traces["stack"], {},
        {"vocoder": ("flowhigh_tpu_torch/models/bigvgan.py",),
         "dsp": ("flowhigh_tpu_torch/dsp/",)}, {})
    # amp_unit all the vocoder's, ew 3/4 of it: 600 + 300 us
    assert readers.window_layer_s(ctx, "vocoder") == (600 + 300) / 1e6
    assert readers.window_layer_s(ctx, "dsp") == 100 / 1e6
    # the span (2000 us) stands for 5 x 2e-3 input seconds
    assert abs(readers.ms_per_audio_s(ctx, "vocoder") - 0.9 / 1e-2) < 1e-9
