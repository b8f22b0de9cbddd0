"""flowhigh_tpu_torch as a package: its configs equal the JAX package's, it
imports nothing of JAX, it runs on CUDA unless told otherwise, and
chip_smoke.py refuses to run without a card."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import flowhigh_tpu.config as jax_config
import flowhigh_tpu_torch
import flowhigh_tpu_torch.config as port_config
from flowhigh_tpu_torch import FlowHighSR, ops

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "flowhigh_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("port_*.py"))
CONFIGS = ["MelConfig", "VocoderConfig", "ModelConfig", "CFMConfig",
           "DataConfig", "TrainConfig", "FlowHighConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match_jax(name):
    port, ref = getattr(port_config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


def test_cfm_methods_match_jax():
    assert port_config.CFMConfig.CFM_METHODS == jax_config.CFMConfig.CFM_METHODS


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flowhigh_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'flowhigh_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from flowhigh_tpu_torch import StreamingSR, boundary_lsd, "
        "log_spectral_distance\n"
        "import flowhigh_tpu_torch.metrics, flowhigh_tpu_torch.streaming\n"
        "import flowhigh_tpu_torch.cli, flowhigh_tpu_torch.ops.probes\n"
        "import flowhigh_tpu_torch.train.data, flowhigh_tpu_torch.app\n"
        "import flowhigh_tpu_torch.train.trainer\n"
        "import flowhigh_tpu_torch.example, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('probe_script', "
        "'scripts/port_bench_act_mxu.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'flowhigh_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "flax", "optax",
                                        "orbax", "flowhigh_tpu"}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = port_config.FlowHighConfig().replace(
        model=port_config.ModelConfig(dim=32, depth=1, heads=2, dim_head=16),
        vocoder=port_config.VocoderConfig(upsample_initial_channel=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowHighSR(small)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        FlowHighSR(small, device="cuda")
    assert FlowHighSR(small, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(ode_method="adaptive"),
                                dict(upsampling_method="librosa"),
                                dict(prior_semantics="paper")])
def test_unported_options_raise(kw):
    """The options that once raised now build and are kept, bf16 feature
    maps (``vocoder_storage_dtype``) with each of them."""
    small = port_config.FlowHighConfig().replace(
        model=port_config.ModelConfig(dim=32, depth=1, heads=2, dim_head=16),
        vocoder=port_config.VocoderConfig(upsample_initial_channel=32))
    sr = FlowHighSR(small, device="cpu", **kw)
    for key, value in kw.items():
        assert getattr(sr, key) == value
    sr = FlowHighSR(small, device="cpu", vocoder_storage_dtype=torch.bfloat16,
                    **kw)
    assert sr.vocoder_storage_dtype == sr.vocoder.storage_dtype == \
        torch.bfloat16
    for key, value in kw.items():
        assert getattr(sr, key) == value


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        ops.snake_activation1d(x, torch.empty(4, device="meta"), None)
    with pytest.raises(ValueError):
        ops.conv1d(x, torch.empty(4, 4, 3, device="meta"), None)
    with pytest.raises(ValueError):
        ops.conv_transpose1d(x, torch.empty(4, 2, 4, device="meta"), None,
                             stride=2)
    a, w = torch.empty(4, device="meta"), torch.empty(4, 4, 3, device="meta")
    with pytest.raises(ValueError):
        ops.act_conv1d(x, a, None, True, w, None, dilation=1)
    with pytest.raises(ValueError):
        ops.amp_unit(x, a, None, a, None, True, w, None, w, None, dilation=1)
    q = torch.empty(1, 2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, q, q, None, 10.0)


def test_chip_smoke_fails_without_a_card():
    # no card here: the script must exit non-zero and print no result line
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_probe_script_refuses_without_a_card():
    res = subprocess.run([sys.executable, "scripts/port_bench_act_mxu.py"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "needs a CUDA card" in res.stderr and not res.stdout


def test_chip_smoke_main_path_launch_counts():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = port_config.VocoderConfig()

    def counts(fuse):
        calls = chip_smoke.main_path_calls(cfg, 1000, fuse)
        return calls, {k: sum(v.values()) for k, v in calls.items()}

    # the default path: 9 units per stage; at C = 768 and 384 no unit fits
    # (2 pairs each), at C <= 192 every unit does; activation_post and
    # conv_post apart
    calls, n = counts(True)
    assert n == {"snake_aa": 1, "conv1d_same": 1, "conv_transpose1d": 5,
                 "act_conv1d": 36, "amp_unit": 27}
    assert {k[0] for k in calls["act_conv1d"]} == {768, 384}
    assert {k[:2] for k in calls["amp_unit"]} == {
        (192, 80000), (96, 240000), (48, 480000)}
    # the unfused path: 5 stages x 3 resblocks x 3 dilations x 2 (act, conv)
    # + the post pair
    calls, n = counts(False)
    assert n == {"snake_aa": 91, "conv1d_same": 91, "conv_transpose1d": 5,
                 "act_conv1d": 0, "amp_unit": 0}
    assert {k[:2] for k in calls["snake_aa"]} == {
        (768, 5000), (384, 20000), (192, 80000), (96, 240000), (48, 480000)}
    assert counts("pairs")[1]["act_conv1d"] == 90
    assert counts("auto")[1]["act_conv1d"] == 30  # the k = 3 pairs


def test_chip_smoke_longform_launch_counts():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = port_config.VocoderConfig()
    # a 5-minute clip: 30,000 frames in 30 windows of 1,064
    calls = chip_smoke.longform_calls(cfg, 30000)
    assert {k: sum(v.values()) for k, v in calls.items()} == {
        "snake_aa": 30, "conv1d_same": 30, "conv_transpose1d": 150,
        "act_conv1d": 1080, "amp_unit": 810}
    assert {k[2] for k in calls["conv_transpose1d"]} == {1064, 5320, 21280,
                                                         85120, 255360}
    # a clip that fits one window is one whole forward
    assert chip_smoke.longform_calls(cfg, 1000) == \
        chip_smoke.main_path_calls(cfg, 1000)


def test_csrc_is_packaged():
    names = {p.name for p in (ROOT / "flowhigh_tpu_torch" / "csrc").glob("*.cu")}
    assert names == {f"{n}.cu" for n in flowhigh_tpu_torch.ops._build.SOURCES}
