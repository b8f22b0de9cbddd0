"""The port's optimizer and learning-rate schedule
(``flowhigh_tpu_torch.train.optimizer``) against the JAX package's optax
ones on the CPU: the schedule at every update index, and updates on fixed
random gradients, plain Adam, AdamW with its >= 2-D decay mask, and
``grad_accum_every=2`` (optax.MultiSteps)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from flowhigh_tpu.config import TrainConfig as JaxTrainConfig
from flowhigh_tpu.train import lr_schedule as jax_lr_schedule
from flowhigh_tpu.train import make_optimizer as jax_make_optimizer
from flowhigh_tpu_torch.config import TrainConfig
from flowhigh_tpu_torch.train import lr_schedule, make_optimizer

SCHEDULES = {
    "warmup": dict(lr=3e-4, initial_lr=1e-5, num_train_steps=1000,
                   num_warmup_steps=100),
    "no_warmup": dict(lr=3e-4, num_train_steps=1000, num_warmup_steps=0),
    "warmup_past_horizon": dict(lr=1e-3, initial_lr=0.0, num_train_steps=50,
                                num_warmup_steps=20),
}


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


@pytest.mark.parametrize("case", SCHEDULES)
def test_lr_schedule_matches_optax(case):
    kw = SCHEDULES[case]
    steps = np.arange(0, 1201 if kw["num_train_steps"] > 100 else 101)
    want = np.asarray(jax.jit(jax.vmap(jax_lr_schedule(JaxTrainConfig(**kw))))(
        jnp.asarray(steps)), np.float64)
    sched = lr_schedule(TrainConfig(**kw))
    got = np.array([sched(int(s)) for s in steps])
    # optax evaluates in float32, the port in float64: two float32 steps of
    # the peak rate apart at most (the cosine near its end, where a step of
    # the cosine is a large share of the rate)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=kw["lr"] * 2.0 ** -22)


# leaves: >= 2-D (decayed under AdamW) and 1-D (not), and one the loss
# never reaches (its .grad stays None: optax sees zeros)
SHAPES = {"w": (6, 5), "conv": (4, 2, 3), "bias": (5,), "gain": (1,),
          "unused": (3,)}
UPDATE_CASES = {
    "adam": dict(),
    "adamw_mask": dict(weight_decay=0.1),
    "accum2": dict(grad_accum_every=2),
}


def _grads(gen, step):
    """Fixed random gradients; every other micro-step scaled up so that the
    clip at 0.5 acts on some updates and not on others."""
    scale = 2.0 if step % 2 else 0.02
    return {k: (None if k == "unused" else
                (scale * gen.standard_normal(s)).astype(np.float32))
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("case", UPDATE_CASES)
def test_updates_match_optax(case):
    kw = dict(lr=1e-2, initial_lr=1e-3, num_train_steps=10,
              num_warmup_steps=2, **UPDATE_CASES[case])
    jcfg, pcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    k = max(pcfg.grad_accum_every, 1)
    gen = np.random.default_rng(0)
    init = {n: (1 + 0.1 * gen.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}
    tx = jax_make_optimizer(jcfg)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    jstate = tx.init(jparams)
    step = jax.jit(lambda g, s, p: tx.update(g, s, p))
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = make_optimizer(pcfg, params.values())
    for i in range(3 * k):  # three updates
        g = _grads(gen, i)
        updates, jstate = step({n: jnp.zeros(SHAPES[n]) if v is None else
                                jnp.asarray(v) for n, v in g.items()},
                               jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.grad = None if g[n] is None else torch.from_numpy(g[n])
        applied = opt.step()
        assert applied == ((i + 1) % k == 0)
        for n, p in params.items():
            if not applied:  # mid-accumulation: nothing moves
                assert torch.equal(p.detach(), before[n])
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=2e-6,
                                       atol=1e-7, err_msg=f"{n} at {i}")
    assert opt.updates == 3 and opt.mini_step == 0
    assert all(float(s["step"]) == 3 for s in opt.inner.state.values())


def test_optimizer_state_round_trip():
    cfg = TrainConfig(lr=1e-2, grad_accum_every=2)
    gen = np.random.default_rng(1)

    def run(opt, params, steps):
        for i in steps:
            for p in params:
                p.grad = torch.from_numpy(_grads(gen, i)["w"])
            opt.step()

    a = [torch.nn.Parameter(torch.ones(6, 5))]
    opt_a = make_optimizer(cfg, a)
    run(opt_a, a, range(3))  # one update and half of the next
    b = [torch.nn.Parameter(a[0].detach().clone())]
    opt_b = make_optimizer(cfg, b)
    buf = io.BytesIO()  # through a file, as Trainer.save writes it
    torch.save(opt_a.state_dict(), buf)
    buf.seek(0)
    opt_b.load_state_dict(torch.load(buf, weights_only=True))
    assert opt_b.mini_step == 1 and opt_b.updates == 1
    gen_state = gen.bit_generator.state
    run(opt_a, a, range(3, 5))
    gen.bit_generator.state = gen_state
    run(opt_b, b, range(3, 5))
    assert torch.equal(a[0], b[0])


def test_clip_is_optax_formula():
    """Clipped gradients are (g / ||g||) * max_norm, not torch's
    clip_grad_norm_ (which divides by ||g|| + 1e-6): one SGD-like Adam
    step cannot show it, so the clipped .grad is read back before Adam."""
    cfg = dataclasses.replace(TrainConfig(), max_grad_norm=0.5)
    p = torch.nn.Parameter(torch.zeros(4))
    opt = make_optimizer(cfg, [p])
    g = torch.tensor([3.0, 4.0, 0.0, 0.0])
    p.grad = g.clone()
    seen = {}
    orig = opt.inner.step

    def spy():
        seen["grad"] = p.grad.clone()
        return orig()

    opt.inner.step = spy
    opt.step()
    want = optax.clip_by_global_norm(0.5).update(jnp.asarray(g.numpy()),
                                                 None)[0]
    np.testing.assert_array_equal(seen["grad"].numpy(), np.asarray(want))
