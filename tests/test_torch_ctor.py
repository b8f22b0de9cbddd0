"""The port's FlowHighSR constructor accepts the JAX constructor's TPU
lowering switches (``fused_vocoder``, ``packed_vocoder``,
``vocoder_kernel_pipeline``), validates them, and builds the same model
whatever they say: bench.py's own constructor call builds the port."""

import inspect

import numpy as np
import pytest
import torch

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu_torch import FlowHighConfig, FlowHighSR

SWITCHES = ("fused_vocoder", "packed_vocoder", "vocoder_kernel_pipeline")


def test_bench_constructor_call_builds_the_port():
    # bench.py:76-77, on the CPU
    sr = FlowHighSR(FlowHighConfig(), cfm_method="independent_cfm_adaptive",
                    ode_method="euler", fused_vocoder=True, device="cpu")
    assert sr.cfm_method == "independent_cfm_adaptive"
    assert sr.ode_method == "euler"
    assert sr.device == torch.device("cpu")
    assert sr.vocoder.cfg == FlowHighConfig().vocoder


def test_switches_have_the_jax_defaults():
    jax_sig = inspect.signature(JaxFlowHighSR.__init__).parameters
    port_sig = inspect.signature(FlowHighSR.__init__).parameters
    for name in SWITCHES:
        assert port_sig[name].default == jax_sig[name].default, name
        assert port_sig[name].kind == inspect.Parameter.KEYWORD_ONLY


TINY = FlowHighConfig().replace(
    model=FlowHighConfig().model.__class__(dim_in=256, dim=32, depth=1,
                                           heads=2, dim_head=16),
    vocoder=FlowHighConfig().vocoder.__class__(
        num_mels=256, upsample_initial_channel=16, upsample_rates=(4,),
        upsample_kernel_sizes=(8,), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1,),)))


@pytest.mark.parametrize("kw", [
    dict(fused_vocoder=False), dict(fused_vocoder=True, packed_vocoder=False),
    dict(packed_vocoder=True), dict(vocoder_kernel_pipeline=1),
    dict(fused_vocoder=True, packed_vocoder=True, vocoder_kernel_pipeline=4)])
def test_switches_do_not_change_the_model(kw):
    ref = FlowHighSR(TINY, device="cpu")
    sr = FlowHighSR(TINY, device="cpu", **kw)
    ref.init_params(0)
    sr.init_params(0)
    got, want = sr.vocoder.state_dict(), ref.vocoder.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 6, 256)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(sr.vocoder(mel), ref.vocoder(mel),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(fused_vocoder=1), dict(fused_vocoder=None), dict(fused_vocoder="yes"),
    dict(packed_vocoder=0), dict(packed_vocoder="auto"),
    dict(vocoder_kernel_pipeline=0), dict(vocoder_kernel_pipeline=-2),
    dict(vocoder_kernel_pipeline=2.0), dict(vocoder_kernel_pipeline=True),
    dict(vocoder_kernel_pipeline=None)])
def test_bad_switch_values_raise(kw):
    with pytest.raises(ValueError):
        FlowHighSR(TINY, device="cpu", **kw)
