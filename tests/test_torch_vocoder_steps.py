"""The port's ``VocoderTrainer.train_step`` against the JAX package's
``VocoderTrainer.train_step`` over three GAN steps on the CPU, from the
same weights on the same batch (tests/test_torch_vocoder_train.py's tiny
configuration, weights and batch). The JAX side is the JAX trainer's own
jitted step, one compile.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowhigh_tpu.config import VocoderConfig as JaxVocoderConfig
from flowhigh_tpu.parallel import make_mesh
from flowhigh_tpu.train import VocoderTrainer as JaxVocoderTrainer
from flowhigh_tpu.train.vocoder_trainer import (
    VocoderTrainState as JaxVocoderTrainState)
from test_torch_vocoder_train import (KW, TINY, make_batch, make_params,
                                      port_leaves, port_trainer, rel_l2)

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and torch's pool then spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return make_params()


@pytest.fixture(scope="module")
def three_steps(params):
    """Both trainers over three GAN steps from ``params`` on ``batch``:
    each step's metrics, the JAX trees after steps 1 and 3, the port's
    state after step 3 and its parameters and gradients after step 1."""
    jtr = JaxVocoderTrainer(JaxVocoderConfig(**TINY),
                            mesh=make_mesh(n_data=1, n_model=1), **KW)
    jstate = JaxVocoderTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=params["gen"],
        mpd_params=params["mpd"], mrd_params=params["mrd"],
        gen_opt=jtr.gen_tx.init(params["gen"]),
        disc_opt=jtr.disc_tx.init({"mpd": params["mpd"],
                                   "mrd": params["mrd"]}))
    batch = make_batch()
    ptr = port_trainer()
    pstate = ptr.init_state(params=params)
    jm, pm, trees = [], [], []
    for i in range(3):
        jstate, m = jtr.train_step(jstate, batch)
        jm.append({k: float(v) for k, v in m.items()})
        trees.append(jax.device_get({"gen": jstate.gen_params,
                                     "mpd": jstate.mpd_params,
                                     "mrd": jstate.mrd_params}))
        pstate, m = ptr.train_step(pstate, batch)
        pm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            step1 = {n: (p.detach().clone(), p.grad.clone())
                     for n, (p, _) in port_leaves(pstate, params).items()}
    return jm, pm, trees, pstate, step1


def test_first_step_matches_jax(three_steps, params):
    """Step 1's three losses within rel 1e-5, and its update of every
    element of every leaf within 1e-3 lr of the JAX trainer's, except
    where the element's gradient lies within 1e-3 x its leaf's RMS of 0.
    Adam's first update is lr x sign(g) element-wise, and the two
    packages' float32 gradients differ by ~1e-4 of their scale
    (test_gan_gradients_match_jax), so such an element may take the other
    sign (measured: 3 of conv_pre's 28,672 elements, gradients of 3e-4 to
    8e-4 against a median of 1.6; no other leaf)."""
    jm, pm, trees, pstate, step1 = three_steps
    for key in ("disc_loss", "gen_loss", "mel_l1"):
        assert abs(pm[0][key] - jm[0][key]) <= 1e-5 * abs(jm[0][key]), key
    lr = 2e-4
    start, want = ({n: w.numpy() for n, (_, w) in
                    port_leaves(pstate, tree).items()}
                   for tree in (params, trees[0]))
    flipped = {}
    for name, (p, g) in step1.items():
        upd, upd_jax = p.numpy() - start[name], want[name] - start[name]
        g = g.numpy()
        clear = np.abs(g) > 1e-3 * np.sqrt(np.mean(g * g))
        assert np.all(np.abs(upd - upd_jax)[clear] <= 1e-3 * lr), name
        n = int(np.sum(np.abs(upd - upd_jax) > 1e-3 * lr))
        if n:
            flipped[name] = n
    assert sum(flipped.values()) <= 1e-4 * sum(g.numel() for _, g in
                                              step1.values()), flipped


def test_three_steps_match_jax(three_steps):
    """Steps 2 and 3's losses within rel 1e-2 and every parameter after
    three steps within rel L2 1e-3 of the JAX trainer's (measured: 1.2e-3
    and 3.7e-4). Named looser than 1e-5: an element whose first update
    took the other sign (test_first_step_matches_jax) moves the GAN's
    next steps, which amplify it."""
    jm, pm, trees, pstate, _ = three_steps
    for j, p in zip(jm[1:], pm[1:]):
        for key in ("disc_loss", "gen_loss", "mel_l1"):
            assert abs(p[key] - j[key]) <= 1e-2 * abs(j[key]), key
    got, want = zip(*((p.detach().numpy().ravel(), w.numpy().ravel())
                      for p, w in port_leaves(pstate, trees[2]).values()))
    assert rel_l2(np.concatenate(got), np.concatenate(want)) <= 1e-3
