"""The port's adaptive ODE solver (``cfm.odeint_adaptive``, dopri5 and
tsit5, per-item step control) against scipy's ``solve_ivp`` and the JAX
package's ``odeint_adaptive`` on the same numpy fields (mirroring
tests/test_cfm.py::TestAdaptiveSolver), and ``generate`` /
``dispatch_generate`` with ``ode_method="adaptive"`` and
``use_torchode=True`` against the JAX package on the tiny pair, with the
solver's statistics."""

import os
import warnings

import numpy as np
import pytest
import scipy.integrate as si
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu.cfm import odeint_adaptive as jax_odeint_adaptive
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch.cfm import odeint_adaptive, odeint_fixed
from flowhigh_tpu_torch.sr import _warn_if_unconverged
from test_torch_sample import jax_tiny
from test_torch_sr import TINY_MODEL, TINY_VOCODER, _configs

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TABLEAUS = ("dopri5", "tsit5")


def _both(f_np, y0: np.ndarray, *args, **kw):
    """(port, JAX) results of the same numpy field, with stats."""
    got = odeint_adaptive(lambda t, y: torch.from_numpy(
        np.asarray(f_np(t.numpy(), y.numpy()), np.float32)),
        torch.from_numpy(y0), *args, return_stats=True, **kw)
    want = jax_odeint_adaptive(
        lambda t, y: f_np(t, y, xp=jnp), jnp.asarray(y0), *args,
        return_stats=True, **kw)
    return got, want


def _same_stats(got, want):
    assert int(got.n_loops) == int(want.n_loops)
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))


def _forced(t, y, xp=np):
    """y' = -2y + sin(10t), t [B] (tests/test_cfm.py's field)."""
    return -2 * y + xp.sin(10 * t).reshape((-1,) + (1,) * (y.ndim - 1))


@pytest.mark.parametrize("tableau", TABLEAUS)
def test_matches_scipy_and_jax(tableau):
    (y, st), (yj, stj) = _both(_forced, np.ones((1, 1), np.float32), 1e-7,
                               1e-7, tableau=tableau)
    ref = si.solve_ivp(lambda t, y: -2 * y + np.sin(10 * t), (0, 1), [1.0],
                       rtol=1e-9, atol=1e-9).y[0, -1]
    # scipy at 1e-9 against the f32 solver at 1e-7 (tests/test_cfm.py's
    # bound); JAX's solver on the same field within 1e-6 (its step counts
    # may differ: see the next test)
    np.testing.assert_allclose(float(y[0, 0]), ref, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-6)
    assert bool(st.converged.all()) and bool(np.asarray(stj.converged).all())


@pytest.mark.parametrize("tableau", TABLEAUS)
def test_linear_field_matches_jax_and_a_dense_grid(rng, tableau):
    a = (rng.standard_normal((4, 8)) * 0.5).astype(np.float32)

    def field(t, y, xp=np):
        return xp.asarray(a) - y * 0.3

    y0 = np.zeros((4, 8), np.float32)
    (y, _), (yj, _) = _both(field, y0, 1e-6, 1e-6, tableau=tableau)
    fixed = odeint_fixed(lambda t, y: torch.from_numpy(a) - y * 0.3,
                         torch.from_numpy(y0), 200, "midpoint")
    np.testing.assert_allclose(y.numpy(), fixed.numpy(), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-6)
    # no step counts here: on a smooth field the 5(4) error estimate of a
    # float32 step is at float32's rounding (y5 == y4 exactly on some
    # steps), so the step sequence follows the last bit of the field's
    # value, and numpy's and XLA's differ there. The counts are held equal
    # where the estimate is truncation, not rounding: the stiff field below
    # and the tiny pair's generate


def _stiff_easy(t, y, xp=np, stiff=60.0):
    """Item 0: y' = -y (easy); item 1: y' = -stiff (y - cos t) (stiff)."""
    tb = t.reshape(-1, 1)
    sel = xp.arange(y.shape[0]).reshape(-1, 1) == 1
    return xp.where(sel, -stiff * (y - xp.cos(tb)), -y)


def test_per_item_step_control():
    y0 = np.ones((2, 4), np.float32)
    (_, st), (_, stj) = _both(_stiff_easy, y0, 1e-4, 1e-4)
    _same_stats(st, stj)  # the JAX solver's steps, above the rounding
    y, st = odeint_adaptive(
        lambda t, y: torch.from_numpy(_stiff_easy(t.numpy(), y.numpy())),
        torch.from_numpy(y0), 1e-6, 1e-6, return_stats=True)
    assert bool(st.converged.all())
    n_easy, n_hard = int(st.n_accepted[0]), int(st.n_accepted[1])
    assert n_hard > 2 * n_easy, (n_easy, n_hard)
    # the stiff item does not change the easy one's steps: alone, it takes
    # the same accepted steps and lands on the same value
    alone, st_alone = odeint_adaptive(
        lambda t, y: -y, torch.ones((1, 4)), 1e-6, 1e-6, return_stats=True)
    assert int(st_alone.n_accepted[0]) == n_easy
    np.testing.assert_array_equal(alone.numpy()[0], y.numpy()[0])
    ref_hard = si.solve_ivp(lambda t, y: -60.0 * (y - np.cos(t)), (0, 1),
                            [1.0], rtol=1e-9, atol=1e-9).y[0, -1]
    np.testing.assert_allclose(float(y[0, 0]), np.exp(-1.0), atol=1e-5)
    np.testing.assert_allclose(float(y[1, 0]), ref_hard, atol=1e-4)


def test_finished_items_stay_frozen():
    """Once the easy item reaches t = 1 the solver goes on for the stiff
    one; the easy item's state must not move in those loops (a zero step,
    never accepted), and the field sees t = 1 for it."""
    seen = []

    def field(t, y):
        seen.append(t.clone())
        return torch.from_numpy(_stiff_easy(t.numpy(), y.numpy()))

    y, st = odeint_adaptive(field, torch.ones((2, 4)), 1e-6, 1e-6,
                            return_stats=True)
    done = [t for t in seen if t[0] >= 1.0]
    assert done and int(st.n_loops) > int(st.n_accepted[0])
    assert all(float(t[0]) == 1.0 for t in done)
    alone = odeint_adaptive(lambda t, y: -y, torch.ones((1, 4)), 1e-6, 1e-6)
    np.testing.assert_array_equal(y.numpy()[0], alone.numpy()[0])


def test_reads_back_once_per_loop(monkeypatch):
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    _, st = odeint_adaptive(lambda t, y: -y, torch.ones((3, 2)), 1e-6, 1e-6,
                            return_stats=True)
    monkeypatch.undo()
    assert len(reads) == int(st.n_loops) > 1


def test_nonconvergence_is_reported():
    (y, st), (_, stj) = _both(lambda t, y, xp=np: -1000.0 * y,
                              np.ones((1, 2), np.float32), 1e-9, 1e-9,
                              max_steps=3)
    _same_stats(st, stj)
    assert not bool(st.converged.all()) and int(st.n_loops) == 3
    with pytest.warns(RuntimeWarning, match="max_steps"):
        _warn_if_unconverged(st)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _warn_if_unconverged(None)  # the fixed grid: nothing to report


def test_unknown_tableau_rejected():
    with pytest.raises(ValueError, match="tableau"):
        odeint_adaptive(lambda t, y: -y, torch.ones((1, 1)), tableau="rk4")
    _, cp = _configs(TINY_MODEL, TINY_VOCODER)
    with pytest.raises(ValueError, match="tableau"):
        FlowHighSR(cp, ode_method="adaptive", ode_tableau="rk4", device="cpu")


# --- generate with the adaptive solver, against the JAX package ---------------

@pytest.fixture(scope="module")
def base_pair():
    cj, cp = _configs(TINY_MODEL, TINY_VOCODER)
    return cj, cp, jax_tiny(cj)


SOLVERS = {"adaptive": dict(ode_method="adaptive"),
           "use_torchode": dict(use_torchode=True)}


@pytest.mark.parametrize("solver", SOLVERS)
def test_generate_adaptive_matches_jax(base_pair, rng, solver):
    cj, cp, base = base_pair
    kw = SOLVERS[solver]
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive", **kw)
    jsr.params = base.params
    jsr.melvoco.vocoder_params = base.melvoco.vocoder_params
    psr = FlowHighSR(cp, jax.device_get(base.params),
                     jax.device_get(base.melvoco.vocoder_params),
                     cfm_method="independent_cfm_adaptive", device="cpu", **kw)
    assert (psr.ode_method, psr.ode_tableau) == (jsr.ode_method,
                                                 jsr.ode_tableau)
    audio = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    want, n48_j, st_j = jsr.dispatch_generate(audio[None], np.array([16000]),
                                              16000)
    got, n48, st = psr.dispatch_generate(audio[None], np.array([16000]), 16000)
    assert int(n48[0]) == int(n48_j[0]) == 48000
    _same_stats(st, st_j)
    assert bool(st.converged.all()) and int(st.n_loops) > 1
    # the fixed-grid generate's bound (tests/test_torch_sr.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_array_equal(psr.generate(audio, 16000), got.numpy())


def test_adaptive_dispatch_reads_back_and_warns(base_pair, rng, monkeypatch):
    """The adaptive path reads its loop condition back (the read the fixed
    grid never makes, tests/test_torch_serving.py), and an item that hits
    max_steps is reported by generate, generate_batch and the serving
    pipeline's fetcher."""
    from flowhigh_tpu_torch import cfm as cfm_mod
    from flowhigh_tpu_torch import sr as sr_mod
    from flowhigh_tpu_torch.serving import ServingPipeline
    _, cp, base = base_pair
    psr = FlowHighSR(cp, jax.device_get(base.params),
                     jax.device_get(base.melvoco.vocoder_params),
                     cfm_method="independent_cfm_adaptive",
                     ode_method="adaptive", ode_atol=1e-9, ode_rtol=1e-9,
                     device="cpu")
    audio = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    monkeypatch.setattr(sr_mod, "odeint_adaptive", lambda *a, **k:
                        cfm_mod.odeint_adaptive(*a, max_steps=2, **k))
    with monkeypatch.context() as m:
        def boom(self):
            raise AssertionError("read back")
        m.setattr(torch.Tensor, "__bool__", boom)
        with pytest.raises(AssertionError, match="read back"):
            psr.dispatch_generate(audio[None], np.array([8000]), 8000)
    for run in (lambda: psr.generate(audio, 8000),
                lambda: psr.generate_batch([audio], 8000)):
        with pytest.warns(RuntimeWarning, match="max_steps"):
            run()
    with pytest.warns(RuntimeWarning, match="max_steps"):
        with ServingPipeline(psr) as srv:
            out = srv.submit(audio, 8000).result()
    assert out.shape == (1, 48000) and np.isfinite(out).all()
