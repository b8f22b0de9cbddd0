"""The port's ``Trainer`` (``flowhigh_tpu_torch.train``) against the JAX
package's on the CPU, mirroring tests/test_train.py: three updates from the
same weights on JAX's draws (losses, logged lr and grad norm, parameters),
kill-and-resume, both packages' exports read by the other, the reference
optimizer, ``fit``'s records and cadences, ``evaluate``, gradient
accumulation and the bf16 default.

The batch: three 48 kHz waves padded to 2.5 s, whose valid lengths (2.5,
1.75 and 1.25 s) lie on both sides of the 2 s crop, so that one item is
cropped and two are zero past their length.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu.config import CFMConfig as JaxCFMConfig
from flowhigh_tpu.config import FlowHighConfig as JaxFlowHighConfig
from flowhigh_tpu.config import ModelConfig as JaxModelConfig
from flowhigh_tpu.config import TrainConfig as JaxTrainConfig
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu.parallel import make_mesh
from flowhigh_tpu.train import Trainer as JaxTrainer
from flowhigh_tpu.train.trainer import TrainState as JaxTrainState
from flowhigh_tpu_torch.compat import (reference_param_order,
                                       vector_field_state_from_jax)
from flowhigh_tpu_torch.config import (CFMConfig, FlowHighConfig, ModelConfig,
                                       TrainConfig, VocoderConfig)
from flowhigh_tpu_torch.train import Trainer
from test_torch_train_loss import jax_draws
from test_torch_vector_options import _field_params

FIELD = dict(dim_in=256, dim=32, depth=2, heads=2, dim_head=8)
TRAIN = dict(batch_size=3, lr=1e-3, num_train_steps=100, num_warmup_steps=2,
             save_model_every=0, weighted_loss=True, cond_freq_masking=True,
             amp_dtype="float32")
CFM = dict(cfm_method="independent_cfm_mix", cond_drop_prob=0.4)
N, LENGTHS = 120_000, [120_000, 84_000, 60_000]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs several
    workers on the machine's cores, and torch's thread pool then spins
    against theirs (a ``fit`` of this file took 27 s under four workers
    with the default pool, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**train):
    kw = {**TRAIN, **train}
    return (JaxFlowHighConfig().replace(model=JaxModelConfig(**FIELD),
                                        cfm=JaxCFMConfig(**CFM),
                                        train=JaxTrainConfig(**kw)),
            FlowHighConfig().replace(model=ModelConfig(**FIELD),
                                     cfm=CFMConfig(**CFM),
                                     train=TrainConfig(**kw)))


@pytest.fixture(scope="module")
def batch():
    gen = np.random.default_rng(0)
    t = np.arange(N) / 48000
    wave = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
            + 0.05 * gen.standard_normal((3, N))).astype(np.float32)
    for i, n in enumerate(LENGTHS):
        wave[i, n:] = 0.0
    cond = (0.5 * wave).astype(np.float32)  # rescaled by the peak norm
    return {"wave": wave, "cond": cond, "lengths": np.array(LENGTHS)}


@pytest.fixture(scope="module")
def params():
    return _field_params(JaxVectorFieldNet(JaxModelConfig(**FIELD)))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def three_updates(batch, params, tmp_path_factory):
    """Both trainers after three updates from ``params`` on ``batch``, the
    port's on the draws JAX's step makes (its key split, as the step
    splits it); each step's metrics."""
    jcfg, pcfg = _configs()
    jtr = JaxTrainer(jcfg, mesh=make_mesh(n_data=1, n_model=1))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=jtr.tx.init(params),
                           rng=jax.random.PRNGKey(0))
    ptr = Trainer(pcfg, results_folder=tmp_path_factory.mktemp("port"),
                  device="cpu")
    pstate = ptr.init_state(0, params=vector_field_state_from_jax(
        params, pcfg.model))
    frames = (N + 2 * 784 - 2048) // 480 + 1  # the encode's frames
    jm, pm = [], []
    for _ in range(3):
        draws = jax_draws(jax.random.split(jstate.rng)[1], (3, frames, 256))
        jstate, m = jtr.train_step(jstate, batch)
        jm.append({k: float(v) for k, v in m.items()})
        pstate, m = ptr.train_step(pstate, batch, draws=draws)
        pm.append({k: float(v) for k, v in m.items()})
    return jtr, jstate, jm, ptr, pstate, pm


def test_three_updates_match_jax(three_updates):
    """Losses and grad norms within rel 1e-5 at each step (measured: 9.1e-8
    and 1.8e-7; the packages' mels differ by their STFTs' precision,
    float64 in the port and float32 in JAX); every leaf after three
    updates within rel L2 1e-5 (measured: 1.9e-7 at most, 1.5e-8 the
    median); the logged lr is the schedule's."""
    jtr, jstate, jm, ptr, pstate, pm = three_updates
    for j, p in zip(jm, pm):
        for key in ("loss", "grad_norm"):
            assert abs(p[key] - j[key]) <= 1e-5 * abs(j[key]), (key, p, j)
    want = vector_field_state_from_jax(jax.device_get(jstate.params),
                                       ptr.model_cfg)
    moved = 0
    for name, p in pstate.net.named_parameters():
        got = p.detach().numpy()
        assert _rel_l2(got, want[name]) <= 1e-5, name
        moved += not np.array_equal(got, want[name].numpy())
    assert moved  # not vacuous: the leaves differ in rounding only
    for upd in (1, 2, 3):  # optax's schedule is float32's
        np.testing.assert_allclose(ptr.schedule(upd - 1),
                                   float(jtr.schedule(upd - 1)), rtol=0,
                                   atol=ptr.config.train.lr * 2.0 ** -22)


def test_null_cond_trains_as_in_jax(three_updates, params):
    """The reference freezes ``null_cond``; the JAX trainer (and so the
    port's) updates it with the condition drop on."""
    _, jstate, _, _, pstate, _ = three_updates
    before = np.asarray(params["params"]["null_cond"])
    got = pstate.net.null_cond.detach().numpy()
    want = np.asarray(jstate.params["params"]["null_cond"])
    assert not np.array_equal(want, before)
    assert _rel_l2(got, want) <= 1e-5


def test_export_loads_into_jax_and_reference_adam(three_updates, tmp_path):
    """The port's ``FLowHigh.3.pt`` loads into the JAX trainer's
    ``load_params`` with equal values, and into torch Adam and
    CosineAnnealingLR built the reference's way, each moment on its own
    parameter and none for ``null_cond``."""
    jtr, _, _, ptr, pstate, _ = three_updates
    path = ptr.save(pstate, tmp_path)
    assert path.name == "trainstate_3.pt"
    pkg_path = tmp_path / "FLowHigh.3.pt"
    jparams = jtr.load_params(pkg_path)
    back = vector_field_state_from_jax(jax.device_get(jparams), ptr.model_cfg)
    for name, p in pstate.net.state_dict().items():
        np.testing.assert_array_equal(back[name].numpy(), p.numpy())

    pkg = torch.load(pkg_path, map_location="cpu", weights_only=True)
    assert pkg["scheduler"]["last_epoch"] == 3
    m = ptr.config.model
    replica = torch_ref.TorchFLowHigh(dim_in=m.dim_in, dim=m.dim,
                                      depth=m.depth, dim_head=m.dim_head,
                                      heads=m.heads)
    assert [n for n, _ in replica.named_parameters()] == \
        reference_param_order(m)
    opt = torch.optim.Adam(replica.parameters(), lr=ptr.config.train.lr,
                           betas=(0.9, 0.99))
    opt.load_state_dict(pkg["optim"])
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(
        opt, T_max=ptr.config.train.num_train_steps)
    sched.load_state_dict(pkg["scheduler"])
    assert sched.last_epoch == 3
    ours = dict(pstate.net.named_parameters())
    n_state = 0
    for name, p in replica.named_parameters():
        if name == "null_cond":
            assert p not in opt.state
            continue
        st, mine = opt.state[p], pstate.optimizer.inner.state[ours[name]]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      mine["exp_avg"].numpy())
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      mine["exp_avg_sq"].numpy())
        assert float(st["step"]) == 3
        n_state += 1
    assert n_state == len(pkg["optim"]["state"]) == len(ours) - 1


def test_jax_export_loads_into_the_port(three_updates, tmp_path):
    jtr, jstate, _, ptr, _, _ = three_updates
    path = tmp_path / "FLowHigh.3.pt"
    jtr.export_torch(jstate, path)
    sd = ptr.load_params(path)
    want = vector_field_state_from_jax(jax.device_get(jstate.params),
                                       ptr.model_cfg)
    assert set(sd) == set(want)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    state = ptr.init_state(1, params=sd)  # and trains on from there
    assert torch.equal(state.net.to_pred.weight, sd["to_pred.weight"])


@pytest.mark.parametrize("trainer", ["Trainer", "VocoderTrainer"])
def test_trainers_refuse_a_mesh_naming_the_roadmap_item(trainer):
    # the JAX trainers take mesh=...; the port's run on one device
    from flowhigh_tpu_torch import train as ptrain
    cls = getattr(ptrain, trainer)
    cfg = _configs()[1] if trainer == "Trainer" else VocoderConfig()
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        cls(cfg, mesh=object(), device="cpu")
    assert cls(cfg, mesh=None, device="cpu")


def test_load_params_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "orbax_4").mkdir()
    tr = Trainer(_configs()[1], device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        tr.load_params(tmp_path / "orbax_4")


# --- the port alone ----------------------------------------------------------------

def _port(tmp, **train):
    cfg = _configs(**train)[1]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, attn_dropout=0.1,
                                                ff_dropout=0.1))
    return Trainer(cfg, results_folder=tmp, device="cpu")


def test_kill_and_resume_is_bit_identical(batch, tmp_path):
    """Four micro-steps straight against two, a save, and a fresh trainer's
    ``fit(auto_resume=True)`` to four: the same parameters, Adam moments,
    accumulator and generator (dropout on, two micro-steps an update)."""
    tr = _port(tmp_path / "a", grad_accum_every=2)
    s = tr.init_state(0)
    for _ in range(3):
        s, _ = tr.train_step(s, batch)

    tr1 = _port(tmp_path / "b", grad_accum_every=2)
    s1 = tr1.init_state(0)
    for _ in range(1):
        s1, _ = tr1.train_step(s1, batch)
    tr1.save(s1)
    del tr1, s1
    tr2 = _port(tmp_path / "b", grad_accum_every=2)
    assert tr2.latest_checkpoint().name == "trainstate_1.pt"
    logs = []
    s2 = tr2.fit(iter(lambda: batch, None), num_steps=2, log_every=10,
                 save_every=0, log_fn=logs.append, auto_resume=True)
    s, _ = tr.train_step(s, batch)
    assert s2.step == s.step == 4
    assert any("auto-resuming" in line for line in logs)
    for a, b in zip(s.net.state_dict().values(),
                    s2.net.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(s.net.parameters(), s2.net.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s.optimizer.inner.state[p][key],
                               s2.optimizer.inner.state[q][key])
    assert torch.equal(s.generator.get_state(), s2.generator.get_state())


def test_fit_records_and_cadences(batch, tmp_path, monkeypatch):
    """``fit`` with two micro-batches an update: ``num_steps`` updates from
    twice as many batches, ``metrics.jsonl`` lines with the JAX trainer's
    keys at the log and eval cadences, lr = schedule(update - 1), a save at
    its cadence, and the message for a missing tensorboard."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tr = _port(tmp_path, grad_accum_every=2)
    consumed = 0

    def data():
        nonlocal consumed
        while True:
            consumed += 1
            yield batch

    logs = []
    state = tr.fit(data(), num_steps=4, log_every=1, save_every=4,
                   eval_every=2, valid_batches=lambda: [batch],
                   log_fn=logs.append, tensorboard=True)
    assert consumed == 8 and state.step == 8 and state.optimizer.updates == 4
    assert any("tensorboard" in line and "missing" in line for line in logs)
    lines = [json.loads(l) for l in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [l for l in lines if "loss" in l]
    valid = [l for l in lines if "valid_loss" in l]
    assert [l["step"] for l in train] == [1, 2, 3, 4]
    assert set(train[0]) == {"step", "loss", "lr", "grad_norm",
                             "steps_per_sec"}
    for l in train:
        assert l["lr"] == tr.schedule(l["step"] - 1)
        assert np.isfinite([l["loss"], l["grad_norm"]]).all()
    assert [l["step"] for l in valid] == [2, 4]
    assert (tmp_path / "trainstate_8.pt").exists()
    assert (tmp_path / "FLowHigh.4.pt").exists()
    pkg = torch.load(tmp_path / "FLowHigh.4.pt", weights_only=True)
    assert pkg["scheduler"]["last_epoch"] == 4
    assert {float(v["step"]) for v in pkg["optim"]["state"].values()} == {4.0}


def test_evaluate_is_deterministic_and_dropout_free(batch, tmp_path):
    """Batch i's draws come from a generator seeded i, in eval mode (no
    dropout), whatever mode the net is in; the mode comes back."""
    tr = _port(tmp_path)  # dropout 0.1
    state = tr.init_state(0)
    net = state.net.train()
    m = tr.evaluate(state, [batch, batch])
    assert m["n_batches"] == 2 and np.isfinite(m["valid_loss"])
    assert tr.evaluate(state, [batch, batch]) == m
    assert net.training
    one = tr.evaluate(state, [batch])["valid_loss"]
    with torch.no_grad():
        args = tr._batch(batch)
        want, dropped = (float(tr._loss_fn(
            net, *args, train=train,
            generator=torch.Generator().manual_seed(0)))
            for train in (False, True))
    assert one == pytest.approx(want, rel=1e-6) and dropped != want


def test_grad_accum_moves_parameters_every_second_step(batch, tmp_path):
    tr = _port(tmp_path, grad_accum_every=2)
    s = tr.init_state(0)
    p0 = [p.detach().clone() for p in s.net.parameters()]
    s, m1 = tr.train_step(s, batch)
    assert all(torch.equal(a, p) for a, p in zip(p0, s.net.parameters()))
    s, m2 = tr.train_step(s, batch)
    assert any(not torch.equal(a, p) for a, p in zip(p0, s.net.parameters()))
    assert np.isfinite([float(m1["loss"]), float(m2["loss"])]).all()


def test_amp_default_is_bf16_and_f32_opts_out(batch, tmp_path):
    assert TrainConfig().amp_dtype == "bfloat16"
    cfg = _configs()[1]
    bf16 = Trainer(cfg.replace(train=dataclasses.replace(
        cfg.train, amp_dtype="bfloat16")), device="cpu")
    assert bf16.model_cfg.compute_dtype == "bfloat16"
    s = bf16.init_state(0)
    assert all(p.dtype == torch.float32 for p in s.net.parameters())
    s, m = bf16.train_step(s, batch)
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert all(p.grad.dtype == torch.float32 for p in s.net.parameters())
    assert Trainer(cfg, device="cpu").model_cfg.compute_dtype == "float32"
