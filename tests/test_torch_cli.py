"""The port's file-to-file CLI (``flowhigh_tpu_torch/cli.py``) against the
JAX package's (``flowhigh_tpu/cli.py``) on the CPU: ``vocoder`` on
reference-layout checkpoint files, ``infer`` on ``--input``,
``--input_dir`` and ``--longform single_pass`` with the same weights on
both sides; the smoke and validation checks of
tests/test_metrics_streaming.py's CLI tests; ``from_pretrained``'s hub glue
and the demo callback (mirroring tests/test_apps.py), and the odd (K - u)
upsampler route of ``models/bigvgan.py``."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

import torch_ref
from flowhigh_tpu import cli as jax_cli
from flowhigh_tpu.sr import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu_torch import FlowHighSR, ops
from flowhigh_tpu_torch import cli
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.compat import seeded_init_
from flowhigh_tpu_torch.models import BigVGAN
from test_torch_serving import FILE_VOCODER, tiny_pair  # noqa: F401

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SOLVER = ["--time_step", "1", "--ode_method", "euler",
          "--cfm_method", "independent_cfm_adaptive"]


def _i16(rng, n, scale=0.2):
    return (rng.standard_normal(n) * scale * 32767).astype(np.int16)


def _read(path):
    sr, data = wavfile.read(path)
    assert sr == 48000 and data.dtype == np.int16
    return data.astype(np.int32)


def _within(got, want, lsb=1):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= lsb


# port against JAX: the repo's generate bound (1e-3, tests/test_torch_sr.py)
# in int16 steps, plus one for the truncation. The two packages' generates
# are not bit-equal (float32 sums in other orders); on the tiny pair the
# written wavs differ by 2 steps at 16 kHz and up to 7 at 8 kHz. The CLI
# itself adds nothing: each side is within 1 step of its own generate
PORT_VS_JAX_LSB = 34


def _as_written(audio):
    """A waveform as the CLIs write it (clip, x 32767, int16)."""
    return (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16).astype(
        np.int32)


# --- vocoder: reference checkpoint files, both CLIs ------------------------------

@pytest.fixture(scope="module")
def vocoder_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc")
    torch.manual_seed(0)
    voc = torch_ref.TorchBigVGAN(pcfg.VocoderConfig(**FILE_VOCODER)).eval()
    with torch.no_grad():
        for name, prm in voc.named_parameters():
            if name.endswith((".alpha", ".beta", ".bias")):
                prm.normal_(0.0, 0.1)
    torch.save({"generator": torch_ref.torch_state_dict_weight_normed(voc)},
               d / "g.pt")
    (d / "config.json").write_text(json.dumps(
        {**FILE_VOCODER, "upsample_rates": list(FILE_VOCODER["upsample_rates"]),
         "upsample_kernel_sizes": list(FILE_VOCODER["upsample_kernel_sizes"]),
         "resblock_kernel_sizes": list(FILE_VOCODER["resblock_kernel_sizes"]),
         "resblock_dilation_sizes": [list(x) for x in
                                     FILE_VOCODER["resblock_dilation_sizes"]],
         "resblock": "1", "activation": "snakebeta", "snake_logscale": True}))
    wavs = d / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    for i, n in enumerate((4800, 7200)):
        wavfile.write(wavs / f"clip{i}.wav", 48000, _i16(rng, n))
    return d


def test_vocoder_matches_jax_cli(vocoder_files, tmp_path):
    d = vocoder_files
    args = ["vocoder", "--input_dir", str(d / "wavs"), "--checkpoint",
            str(d / "g.pt"), "--config", str(d / "config.json")]
    assert jax_cli.main(args + ["--output_dir", str(tmp_path / "j")]) == 0
    assert cli.main(args + ["--output_dir", str(tmp_path / "p")] + CPU) == 0
    for i, n in enumerate((4800, 7200)):
        want = _read(tmp_path / "j" / f"clip{i}_generated.wav")
        got = _read(tmp_path / "p" / f"clip{i}_generated.wav")
        assert len(got) == n
        _within(got, want)


def test_vocoder_rejects_other_rates(tmp_path):
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    wavfile.write(wavs / "a.wav", 16000, np.zeros(1600, np.int16))
    small = tmp_path / "small.json"
    small.write_text(json.dumps({
        "num_mels": 256, "upsample_initial_channel": 16,
        "upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
        "resblock": "1", "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1]]}))
    with pytest.raises(ValueError, match="48 kHz"):
        cli.main(["vocoder", "--input_dir", str(wavs), "--output_dir",
                  str(tmp_path / "o"), "--config", str(small)] + CPU)


# --- infer: the same weights through both CLIs -----------------------------------

@pytest.fixture
def both_from_local(tiny_pair, monkeypatch):  # noqa: F811
    """Each package's FlowHighSR.from_local returns the tiny pair's model."""
    jsr, psr = tiny_pair
    monkeypatch.setattr(JaxFlowHighSR, "from_local",
                        classmethod(lambda cls, *a, **k: jsr))
    monkeypatch.setattr(FlowHighSR, "from_local",
                        classmethod(lambda cls, *a, **k: psr))
    return jsr, psr


def _infer_both(tmp_path, io_args):
    """Run ``infer`` through both CLIs with ``io_args(side)``."""
    for side, main in (("j", jax_cli.main), ("p", cli.main)):
        extra = CPU if side == "p" else []
        assert main(["infer", "--ckpt_dir", "x"] + SOLVER + io_args(side)
                    + extra) == 0


@pytest.mark.parametrize("mode", [[], ["--longform", "single_pass"]])
def test_infer_file_matches_jax_cli(both_from_local, tmp_path, rng, mode):
    _, psr = both_from_local
    audio = _i16(rng, 12000)
    inp = tmp_path / "in.wav"
    wavfile.write(inp, 16000, audio)
    _infer_both(tmp_path, lambda side: ["--input", str(inp), "--output",
                                        str(tmp_path / f"{side}.wav")] + mode)
    got, want = _read(tmp_path / "p.wav"), _read(tmp_path / "j.wav")
    assert len(got) == 36000
    direct = (psr.generate_longform(audio.astype(np.float32) / 32768.0, 16000)
              if mode else psr.generate(audio, 16000))
    _within(got, _as_written(direct[0]))  # the CLI adds nothing
    _within(got, want, PORT_VS_JAX_LSB)


def test_infer_dir_matches_jax_cli(both_from_local, tmp_path, rng):  # noqa: F811
    in_dir = tmp_path / "wavs"
    in_dir.mkdir()
    clips = [(16000, 8000), (8000, 6000), (16000, 16000)]
    for i, (sr, n) in enumerate(clips):
        wavfile.write(in_dir / f"clip{i}.wav", sr, _i16(rng, n))
    _infer_both(tmp_path, lambda side: [
        "--input_dir", str(in_dir), "--output_dir", str(tmp_path / side),
        "--wire", "int16"])
    _, psr = both_from_local
    for i, (sr, n) in enumerate(clips):
        got = _read(tmp_path / "p" / f"clip{i}_48k.wav")
        want = _read(tmp_path / "j" / f"clip{i}_48k.wav")
        assert len(got) == n * 48000 // sr
        audio = wavfile.read(in_dir / f"clip{i}.wav")[1]
        # the int16 output wire's rounding, then the CLI's truncation
        _within(got, _as_written(psr.generate(audio, sr)[0]))
        _within(got, want, PORT_VS_JAX_LSB)


# --- tests/test_metrics_streaming.py's CLI checks, on the port -------------------

def test_infer_smoke(tmp_path, rng):
    inp, outp = tmp_path / "in.wav", tmp_path / "out.wav"
    wavfile.write(inp, 16000, _i16(rng, 16000))
    for mode in ([], ["--longform", "single_pass"]):
        assert cli.main(["infer", "--input", str(inp), "--output", str(outp),
                         "--tiny"] + SOLVER + mode + CPU) == 0
        assert len(_read(outp)) == 48000


def test_infer_dir_mode_serves_all(tmp_path, rng):
    in_dir, out_dir = tmp_path / "wavs", tmp_path / "out"
    in_dir.mkdir()
    lens = [8000, 16000, 12000]
    for i, n in enumerate(lens):
        wavfile.write(in_dir / f"clip{i}.wav", 16000, _i16(rng, n))
    assert cli.main(["infer", "--input_dir", str(in_dir), "--output_dir",
                     str(out_dir), "--tiny", "--wire", "int16"]
                    + SOLVER + CPU) == 0
    for i, n in enumerate(lens):
        assert len(_read(out_dir / f"clip{i}_48k.wav")) == n * 3


def test_infer_arg_validation(tmp_path):
    assert cli.main(["infer", "--tiny"] + CPU) == 2
    assert cli.main(["infer", "--input", "a.wav", "--output", "b.wav",
                     "--input_dir", str(tmp_path), "--tiny"] + CPU) == 2
    assert cli.main(["infer", "--input_dir", str(tmp_path), "--tiny"] + CPU) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["infer", "--input_dir", str(empty), "--output_dir",
                     str(tmp_path / "o"), "--tiny"] + CPU) == 2


def test_unported_paths_raise(tmp_path, rng, monkeypatch):
    inp = tmp_path / "in.wav"
    wavfile.write(inp, 16000, _i16(rng, 1600))
    io = ["--input", str(inp), "--output", str(tmp_path / "o.wav")]
    # the ConvNeXt backbone is ported: the CLI writes the same model's
    # generate (seeded weights, seed 0) within one int16 step
    assert cli.main(["infer", "--tiny", "--architecture", "convnext"] + io
                    + SOLVER + CPU) == 0
    model = FlowHighSR(cli.tiny_config(2, "convnext"),
                       cfm_method="independent_cfm_adaptive",
                       ode_method="euler", sigma=0.0, device="cpu")
    model.init_params(0)
    want = model.generate(wavfile.read(inp)[1], 16000, timestep=1)
    _within(_read(tmp_path / "o.wav"), _as_written(want[0]))
    # train and its tensor-parallel mesh are ported: one process cannot
    # hold a 1 x 2 mesh, and says so as the JAX package's make_mesh does
    with pytest.raises(AssertionError, match="needs more than 1 devices"):
        cli.main(["train", "--steps", "1", "--tp", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["infer", "--tiny"] + io)  # --device defaults to cuda


# --- the odd (K - u) upsamplers: the library conv, by the JAX package's rule ----

def test_odd_upsamplers_route_to_the_library_conv():
    # flowhigh_tpu/models/bigvgan.py sends an upsampler to kernel C only
    # when K - u is even; the port's forward follows the same rule
    cfg = cli.tiny_config().vocoder
    voc = seeded_init_(BigVGAN(cfg).eval(), 0)
    routed = []
    voc_cls_calls = BigVGAN.library_upsamplers
    orig = BigVGAN._upsample

    def spy(self, x, up, u):
        k = up.weight.shape[-1]
        before = BigVGAN.library_upsamplers
        y = orig(self, x, up, u)
        routed.append(((u, k), BigVGAN.library_upsamplers - before))
        return y

    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 6, 256)).astype(np.float32))
    with torch.inference_mode():
        BigVGAN._upsample = spy
        try:
            voc(mel)
        finally:
            BigVGAN._upsample = orig
    assert routed == [((u, k), (k - u) % 2) for u, k in
                      zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)]
    assert BigVGAN.library_upsamplers - voc_cls_calls == 2


@pytest.mark.parametrize("u,k", [(5, 11), (4, 8), (3, 7), (2, 4), (8, 16),
                                 (5, 10), (3, 6), (2, 5), (4, 9)])
def test_upsampler_route_is_the_parity_of_k_minus_u(monkeypatch, u, k):
    # flowhigh_tpu/models/bigvgan.py:453-454: use_pallas_up needs
    # (k - u) % 2 == 0; else XLA's conv_transpose1d, padding (k - u) // 2
    from flowhigh_tpu_torch.models import bigvgan as voc_mod
    taken = []
    monkeypatch.setattr(voc_mod, "conv_transpose1d",
                        lambda x, w, b, *, stride, dot_dtype: taken.append(
                            (stride, dot_dtype)) or "kernel C")
    stub = types.SimpleNamespace(boundary_dtype=torch.bfloat16)
    up = torch.nn.ConvTranspose1d(4, 3, k, stride=u)
    x = torch.randn(1, 4, 5)
    n0 = BigVGAN.library_upsamplers
    y = BigVGAN._upsample(stub, x, up, u)
    if (k - u) % 2 == 0:
        assert y == "kernel C" and taken == [(u, torch.bfloat16)]
        assert BigVGAN.library_upsamplers == n0
    else:
        assert not taken and BigVGAN.library_upsamplers == n0 + 1
        want = torch.nn.functional.conv_transpose1d(
            x, up.weight, up.bias, stride=u, padding=(k - u) // 2)
        assert y.dtype == torch.float32 and y.shape[-1] == 4 * u + k - (
            k - u) // 2 * 2
        torch.testing.assert_close(y, want, atol=0, rtol=0)


def test_odd_upsamplers_give_the_same_output_as_before():
    # before the route, every upsampler went through ops.conv_transpose1d,
    # whose CPU path is the same float32 transposed conv
    cfg = cli.tiny_config().vocoder
    voc = seeded_init_(BigVGAN(cfg).eval(), 0)
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 7, 256)).astype(np.float32))

    def through_kernel_c(self, x, up, u):
        return ops.conv_transpose1d(x, up.weight, up.bias, stride=u)

    with torch.inference_mode():
        got = voc(mel)
        orig = BigVGAN._upsample
        BigVGAN._upsample = through_kernel_c
        try:
            want = voc(mel)
        finally:
            BigVGAN._upsample = orig
    # an odd pair gives (T - 1) u - 2 pad + K outputs, one more than u T
    assert got.shape == (2, 7 * 480 + 13)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --- from_pretrained and the demos (tests/test_apps.py) --------------------------

def test_from_pretrained_hub_glue(monkeypatch, tmp_path):
    requested = []

    def fake_download(repo_id, filename):
        assert repo_id == "ResembleAI/FlowHigh"
        requested.append(filename)
        p = tmp_path / filename
        p.write_bytes(b"")
        return str(p)

    fake = types.ModuleType("huggingface_hub")
    fake.hf_hub_download = fake_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    loaded = {}
    monkeypatch.setattr(FlowHighSR, "from_local", classmethod(
        lambda cls, d, *a, **k: loaded.update(dir=Path(d), **k) or "model"))
    assert FlowHighSR.from_pretrained(device="cpu") == "model"
    assert set(requested) == {
        "FLowHigh_basic_400k.json", "bigvgan_48khz_256band.json",
        "FLowHigh_basic_400k.pt", "bigvgan_48khz_256band.pt"}
    assert loaded == {"dir": tmp_path, "device": "cpu"}


def test_from_pretrained_without_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="from_local"):
        FlowHighSR.from_pretrained()


def test_demo_callback_contract(rng):
    from flowhigh_tpu_torch import app

    class Stub:
        def generate(self, wav, sr, target_sr=48000, timestep=1):
            assert wav.dtype == np.float32
            return np.full((1, int(len(wav) * target_sr // sr)), 1.7,
                           np.float32)

    old, app.model = app.model, Stub()
    try:
        out_sr, out = app.generate((16000, _i16(rng, 1600, 0.3)), 48000, 1)
    finally:
        app.model = old
    assert out_sr == 48000 and out.dtype == np.int16
    assert out.shape == (4800,) and out.max() == 32767
    assert hasattr(app, "gr")


def test_demo_main_exits_without_gradio():
    r = subprocess.run([sys.executable, "-m", "flowhigh_tpu_torch.app"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    if r.returncode == 0:
        pytest.skip("gradio installed in this environment")
    assert "gradio is not installed" in (r.stderr + r.stdout)


def test_example_uses_current_api(monkeypatch, tmp_path, rng):
    from flowhigh_tpu_torch import example
    inp, outp = tmp_path / "in.wav", tmp_path / "out.wav"
    wavfile.write(inp, 16000, _i16(rng, 1600))
    tiny = FlowHighSR(cli.tiny_config(), cfm_method="independent_cfm_adaptive",
                      ode_method="euler", device="cpu")
    seen = {}
    monkeypatch.setattr(FlowHighSR, "from_local", classmethod(
        lambda cls, d: seen.setdefault("dir", d) and tiny))
    assert example.main([str(inp), str(outp), "ckpt"]) == 0
    assert seen["dir"] == "ckpt" and len(_read(outp)) == 4800
