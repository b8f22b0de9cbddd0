"""``python -m flowhigh_tpu_torch.cli train`` and the reference config
loader against the JAX package's, on the CPU.

``FlowHighConfig.from_reference_json`` reads every key and default as the
JAX loader does. The CLI's ``train`` (the JAX ``cmd_train``) runs on a tiny
reference JSON (a 64-wide, 2-layer field, batch 2, the synthetic corpus):
it writes finite losses, resumes from the newest full state by itself, and
from a checkpoint's weights with ``--resume``; what it has not ported (the
tensor-parallel mesh, a multi-process launch) raises naming ROADMAP.md
queue 1 item 13.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import flowhigh_tpu.train as jax_train
from flowhigh_tpu.config import FlowHighConfig as JaxFlowHighConfig
from flowhigh_tpu_torch import cli
from flowhigh_tpu_torch import train as ptrain
from flowhigh_tpu_torch.config import FlowHighConfig

TINY = {"data": {"data_path": ""},
        "model": {"dim": 64, "n_layers": 2, "n_heads": 2, "dim_head": 16,
                  "cfm_path": "basic_cfm"},
        "train": {"batchsize": 2, "log_every": 1, "save_model_every": 2}}
# every key the loader reads, none at its default
FULL = {"random_seed": 7,
        "data": {"samplingrate": 44100, "n_fft": 1024, "win_length": 1000,
                 "hop_length": 441, "n_mel_channels": 128, "mel_fmin": 40.0,
                 "mel_fmax": 20000.0, "data_path": "/data/train",
                 "valid_path": "/data/valid", "downsample_min": 8000,
                 "downsample_max": 24000, "downsampling_method": "librosa"},
        "model": {"architecture": "convnext", "dim": 512, "n_layers": 4,
                  "n_heads": 8, "dim_head": 32,
                  "cfm_path": "independent_cfm_mix", "sigma": "0.001"},
        "train": {"batchsize": 16, "lr": "1e-3", "initial_lr": 2e-6,
                  "n_train_steps": 5000, "n_warmup_steps": 100,
                  "log_every": 5, "save_model_every": 1000,
                  "save_dir": "./out", "weighted_loss": 1,
                  "random_split_seed": 11}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other training files (several pytest
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("content", [FULL, {}, TINY], ids=["full", "empty",
                                                          "tiny"])
def test_from_reference_json_equals_the_jax_loader(tmp_path, content):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(content))
    ours = FlowHighConfig.from_reference_json(path)
    theirs = JaxFlowHighConfig.from_reference_json(path)
    for name in ("mel", "vocoder", "model", "cfm", "data", "train"):
        a, b = getattr(ours, name), getattr(theirs, name)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
        assert {f.name for f in dataclasses.fields(a)} == \
            {f.name for f in dataclasses.fields(b)}, name


def _metrics(folder):
    return [json.loads(ln) for ln in
            (folder / "metrics.jsonl").read_text().splitlines()]


def _train(config, save_dir, *extra):
    return cli.main(["train", "--config", str(config), "--save_dir",
                     str(save_dir), "--device", "cpu", *extra])


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))
    out = tmp_path / "results"
    assert _train(config, out, "--steps", "2") == 0
    printed = capsys.readouterr().out
    # the split the JAX CLI makes of the same synthetic corpus
    tr, va = jax_train.random_split(
        jax_train.SyntheticAudioDataset(n_items=256, seconds=3.0), 0.05, 53)
    assert f"[train] {len(tr)} train / {len(va)} valid" in printed
    assert "FLowHigh vector field parameter summary" in printed
    lines = _metrics(out)
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])
               for ln in lines)
    assert (out / "trainstate_2.pt").exists() and (out / "FLowHigh.2.pt").exists()

    # auto-resume: the full state of update 2, then update 3 only
    assert _train(config, out, "--steps", "3") == 0
    assert "auto-resuming from" in capsys.readouterr().out
    assert [ln["step"] for ln in _metrics(out)] == [1, 2, 3]

    # --resume: update 2's weights in a fresh state (step 0, a new
    # optimizer), no auto-resume
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    (fresh / "trainstate_1.pt").write_bytes(
        (out / "trainstate_2.pt").read_bytes())
    assert _train(config, fresh, "--steps", "1", "--resume",
                  str(out / "FLowHigh.2.pt")) == 0
    assert "auto-resuming" not in capsys.readouterr().out
    assert [ln["step"] for ln in _metrics(fresh)] == [1]
    tr = ptrain.Trainer(FlowHighConfig.from_reference_json(config),
                        device="cpu")
    want = tr.load_params(out / "FLowHigh.2.pt")
    got = torch.load(out / "trainstate_2.pt", weights_only=True)["net"]
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_cli_train_refuses_what_is_not_ported(tmp_path, monkeypatch):
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        _train(config, tmp_path, "--tp", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        _train(config, tmp_path)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # --device defaults to cuda
        cli.main(["train", "--config", str(config)])
