"""The port's serving surface on the CPU: StagePipeline (mirroring
tests/test_pipeline.py), ServingPipeline (mirroring tests/test_serving.py),
generate_batch / dispatch_generate against the JAX package and against
per-clip generate, the int16 output wire, and from_local on checkpoint
files that the tests write from tests/torch_ref.py modules."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ref
from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu.sr import _wire_int16 as jax_wire_int16
from flowhigh_tpu_torch import FlowHighSR
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.pipeline import StagePipeline
from flowhigh_tpu_torch.serving import ServingPipeline, request_seed
from flowhigh_tpu_torch.sr import _wire_int16

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# tests/test_sr.py's TINY config
TINY_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
TINY_VOCODER = dict(num_mels=256, upsample_initial_channel=32,
                    upsample_rates=(8, 5, 4, 3),
                    upsample_kernel_sizes=(16, 10, 8, 6),
                    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def _port_config(model=TINY_MODEL, vocoder=TINY_VOCODER):
    return pcfg.FlowHighConfig().replace(model=pcfg.ModelConfig(**model),
                                         vocoder=pcfg.VocoderConfig(**vocoder))


@pytest.fixture(scope="module")
def tiny_model():
    m = FlowHighSR(_port_config(), cfm_method="independent_cfm_adaptive",
                   ode_method="euler", device="cpu")
    m.init_params(0)
    return m


def _clip(rng, n, scale=0.3):
    return (rng.standard_normal(n) * scale).astype(np.float32)


# --- StagePipeline (tests/test_pipeline.py) --------------------------------------

class TestStagePipeline:
    def test_fifo_order_preserved(self):
        out = []
        pipe = StagePipeline([lambda x: x * 2, lambda x: x + 1, out.append],
                             depths=[2, 2])
        for i in range(50):
            pipe.put(i)
        pipe.close()
        assert out == [2 * i + 1 for i in range(50)]
        assert pipe.stage_errors == []

    def test_none_drops_item(self):
        out = []
        pipe = StagePipeline([lambda x: None if x % 2 else x, out.append],
                             depths=[2])
        for i in range(10):
            pipe.put(i)
        pipe.close()
        assert out == [0, 2, 4, 6, 8]

    def test_stage_exception_recorded_not_deadlocked(self):
        out = []

        def boom(x):
            if x == 3:
                raise RuntimeError("stage bug")
            return x

        pipe = StagePipeline([boom, out.append], depths=[1])
        for i in range(6):
            pipe.put(i)
        pipe.close()  # must return despite the raise
        assert out == [0, 1, 2, 4, 5]
        assert len(pipe.stage_errors) == 1
        assert "stage bug" in str(pipe.stage_errors[0])

    def test_backpressure_bounds_inflight(self):
        inflight_max = []
        lock = threading.Lock()
        state = {"produced": 0, "consumed": 0}

        def produce(x):
            with lock:
                state["produced"] += 1
                inflight_max.append(state["produced"] - state["consumed"])
            return x

        def consume(x):
            time.sleep(0.01)
            with lock:
                state["consumed"] += 1

        pipe = StagePipeline([produce, consume], depths=[1])
        for i in range(20):
            pipe.put(i)
        pipe.close()
        assert state["consumed"] == 20
        assert max(inflight_max) <= 3  # 1 queued + 1 in stage hand + self

    def test_depth_count_validated(self):
        with pytest.raises(ValueError, match="depths"):
            StagePipeline([lambda x: x], depths=[1])

    def test_put_never_blocks(self):
        release = threading.Event()

        def slow(x):
            release.wait(5)

        pipe = StagePipeline([slow], depths=[])
        t0 = time.perf_counter()
        for i in range(100):
            pipe.put(i)
        assert time.perf_counter() - t0 < 1.0
        release.set()
        pipe.close()


# --- ServingPipeline (tests/test_serving.py) -------------------------------------

class TestServingPipeline:
    def test_matches_generate_with_pinned_seed(self, tiny_model, rng):
        audio = _clip(rng, 16000)
        direct = tiny_model.generate(audio, 16000, seed=7)
        with ServingPipeline(tiny_model) as srv:
            served = srv.submit(audio, 16000, seed=7).result(timeout=120)
        np.testing.assert_array_equal(served, direct)

    def test_many_in_flight_orders_and_shapes(self, tiny_model, rng):
        clips = [_clip(rng, n) for n in (8000, 16000, 12000, 24000, 4000, 16000)]
        srs = [16000, 16000, 24000, 24000, 16000, 16000]
        with ServingPipeline(tiny_model, max_in_flight=3) as srv:
            outs = srv.generate_many(clips, srs, seeds=list(range(6)))
        for a, r, o, s in zip(clips, srs, outs, range(6)):
            assert o.shape[0] == 1 and o.dtype == np.float32
            assert o.shape[1] == len(a) * 48000 // r
            np.testing.assert_array_equal(o, tiny_model.generate(a, r, seed=s))

    def test_default_seeds_differ_per_request(self, tiny_model, rng):
        # needs a stochastic prior: under the reference prior semantics
        # independent_cfm_adaptive is deterministic (sigma = 0)
        audio = _clip(rng, 16000)
        tiny_model.set_cfm_method("basic_cfm")
        try:
            with ServingPipeline(tiny_model, seed=5) as srv:
                a, b = srv.generate_many([audio, audio], 16000)
            # request i draws from request_seed(seed, i)
            want = tiny_model.generate(audio, 16000, seed=request_seed(5, 1))
        finally:
            tiny_model.set_cfm_method("independent_cfm_adaptive")
        assert a.shape == b.shape
        assert not np.array_equal(a, b)
        np.testing.assert_array_equal(b, want)
        assert len({request_seed(0, i) for i in range(100)}) == 100

    def test_int16_wire_close_to_float(self, tiny_model, rng):
        audio = _clip(rng, 16000)
        with ServingPipeline(tiny_model) as srv_f:
            ref = srv_f.submit(audio, 16000, seed=3).result(timeout=120)
        with ServingPipeline(tiny_model, wire="int16") as srv_i:
            got = srv_i.submit(audio, 16000, seed=3).result(timeout=120)
        assert got.dtype == np.float32
        assert np.abs(got - np.clip(ref, -1, 1)).max() <= (0.5 / 32767) + 1e-7

    def test_int16_scale_input_convention(self, tiny_model, rng):
        # |x| > 1 float input is int16 scale (the reference's convention)
        audio = _clip(rng, 16000, scale=8000)
        with ServingPipeline(tiny_model) as srv:
            served = srv.submit(audio, 16000, seed=1).result(timeout=120)
        np.testing.assert_array_equal(
            served, tiny_model.generate(audio, 16000, seed=1))

    def test_int16_input_wire_bit_matches_float_path(self, tiny_model, rng):
        audio = (rng.standard_normal(16000) * 8000).astype(np.int16)
        with ServingPipeline(tiny_model) as srv:
            srv.warmup(16000, 1.0, dtype=np.int16)
            served = srv.submit(audio, 16000, seed=4).result(timeout=120)
        np.testing.assert_array_equal(
            served, tiny_model.generate(audio, 16000, seed=4))
        np.testing.assert_array_equal(
            served, tiny_model.generate(audio.astype(np.float32) / 32768.0,
                                        16000, seed=4))

    def test_request_error_does_not_kill_pipeline(self, tiny_model, rng):
        good = _clip(rng, 16000)
        with ServingPipeline(tiny_model) as srv:
            bad_fut = srv.submit(good, 0)  # rate too low for the bucket
            good_fut = srv.submit(good, 16000, seed=2)
            with pytest.raises(ValueError, match="too low"):
                bad_fut.result(timeout=120)
            out = good_fut.result(timeout=120)
        np.testing.assert_array_equal(
            out, tiny_model.generate(good, 16000, seed=2))

    def test_submit_validation_is_synchronous(self, tiny_model):
        srv = ServingPipeline(tiny_model)
        try:
            with pytest.raises(ValueError, match=r"\[T\] or \[1, T\]"):
                srv.submit(np.zeros((2, 2, 2), np.float32), 16000)
            with pytest.raises(ValueError, match="empty"):
                srv.submit(np.zeros((0,), np.float32), 16000)
        finally:
            srv.close()

    def test_close_idempotent_and_rejects_new(self, tiny_model, rng):
        audio = _clip(rng, 8000)
        srv = ServingPipeline(tiny_model)
        fut = srv.submit(audio, 16000, seed=0)
        srv.close()
        assert fut.result(timeout=120).shape[0] == 1  # drained before stop
        srv.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(audio, 16000)

    def test_constructor_validation(self, tiny_model):
        with pytest.raises(ValueError, match="wire"):
            ServingPipeline(tiny_model, wire="f8")
        with pytest.raises(ValueError, match="max_in_flight"):
            ServingPipeline(tiny_model, max_in_flight=0)

    @pytest.mark.slow
    def test_soak_smoke_no_host_leak(self, tiny_model, rng):
        """tests/test_serving.py's soak test on the port's pipeline:
        hundreds of clips through one pipeline all complete with no stage
        error, and host RSS growth plateaus phase over phase rather than
        staying linear. RSS is the whole process's, so the floor is the
        JAX test's 15 MB."""
        def rss_mb():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * 4096 / 1e6

        clip = (rng.standard_normal(8000) * 32000).astype(np.int16)
        per_phase = 100
        growth = []
        with ServingPipeline(tiny_model, max_in_flight=4,
                             wire="int16") as srv:
            srv.submit(clip, 16000).result()  # first-use set-up outside
            for _phase in range(3):
                r0 = rss_mb()
                futs = [srv.submit(clip, 16000) for _ in range(per_phase)]
                outs = [f.result() for f in futs]
                growth.append(rss_mb() - r0)
                assert len(outs) == per_phase
                assert all(o.dtype == np.float32 and o.size for o in outs)
            assert not srv._pipe.stage_errors
        assert growth[2] < max(15.0, 0.5 * growth[0]), (
            f"host RSS growth not plateauing: {growth} MB per "
            f"{per_phase}-clip phase")

    def test_warmup(self, tiny_model):
        with ServingPipeline(tiny_model) as srv:
            srv.warmup(16000, 0.5)
            assert not srv._pipe.stage_errors


# --- generate_batch, dispatch_generate, the int16 output wire ------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX package's FlowHighSR (sigma 0: a deterministic prior) and the
    port with the same weights: the vector field from a real flax init, the
    vocoder (no norms) from fan-in normals with every 1-D leaf perturbed."""
    cj = jcfg.FlowHighConfig().replace(
        model=jcfg.ModelConfig(**TINY_MODEL),
        vocoder=jcfg.VocoderConfig(**TINY_VOCODER))
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler")
    r1, r2 = jax.random.split(jax.random.PRNGKey(3))
    mel = jnp.zeros((1, 16, 256))
    jsr.params = jsr.net.init(r1, mel, times=jnp.zeros(()), cond=mel)
    voc = jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2))
    leaves, tree = jax.tree_util.tree_flatten(voc)
    gen = np.random.default_rng(4)
    leaves = [np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for v in leaves]
    jsr.melvoco.vocoder_params = jax.tree_util.tree_unflatten(tree, leaves)
    psr = FlowHighSR(_port_config(), jax.device_get(jsr.params),
                     jsr.melvoco.vocoder_params,
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    return jsr, psr


def _no_read_back(name):
    def call(*args, **kw):
        raise AssertionError(f"Tensor.{name} read a value back")
    return call


class TestBatch:
    def test_generate_batch_matches_jax(self, tiny_pair, rng):
        jsr, psr = tiny_pair
        audios = [_clip(rng, 8000), _clip(rng, 16000), _clip(rng, 12000),
                  (rng.standard_normal(24000) * 8000).astype(np.int16)]
        srs = [8000, 16000, 16000, 24000]
        want = jsr.generate_batch(audios, srs, timestep=1)
        got = psr.generate_batch(audios, srs, timestep=1)
        assert [g.shape for g in got] == [w.shape for w in want] == [
            (1, 48000), (1, 48000), (1, 36000), (1, 48000)]
        for g, w in zip(got, want):
            # as tests/test_torch_sr.py::test_generate_matches_jax
            np.testing.assert_allclose(g, w, atol=1e-3)

    def test_batch_rows_match_generate(self, tiny_model, rng):
        a, b = _clip(rng, 16000), _clip(rng, 12000)
        outs = tiny_model.generate_batch([a, b], 16000, timestep=1, seed=3)
        for clip, out in zip((a, b), outs):
            # a batch of two against one clip: matmuls of another height
            # sum in another order
            np.testing.assert_allclose(
                out, tiny_model.generate(clip, 16000, seed=3), atol=1e-4)

    def test_batch_int16_group_bit_matches_float(self, tiny_model, rng):
        a = (rng.standard_normal(16000) * 8000).astype(np.int16)
        b = (rng.standard_normal(16000) * 8000).astype(np.int16)
        f_outs = tiny_model.generate_batch(
            [a.astype(np.float32) / 32768.0, b.astype(np.float32) / 32768.0],
            16000, timestep=1, seed=5)
        i_outs = tiny_model.generate_batch([a, b], 16000, timestep=1, seed=5)
        for o_i, o_f in zip(i_outs, f_outs):
            np.testing.assert_array_equal(o_i, o_f)

    def test_batch_mixed_dtype_group_falls_back_to_float(self, tiny_model, rng):
        a = (rng.standard_normal(16000) * 8000).astype(np.int16)
        b = _clip(rng, 16000)
        mixed = tiny_model.generate_batch([a, b], 16000, timestep=1, seed=5)
        all_f = tiny_model.generate_batch(
            [a.astype(np.float32) / 32768.0, b], 16000, timestep=1, seed=5)
        for o_m, o_f in zip(mixed, all_f):
            np.testing.assert_array_equal(o_m, o_f)

    def test_dispatch_generate_returns_device_tensors(self, tiny_model, rng,
                                                      monkeypatch):
        audio = _clip(rng, 16000)
        batch = np.zeros((2, 16000), np.float32)
        batch[0], batch[1, :8000] = audio, audio[:8000]
        # the fixed grid reads nothing back: every host read of a tensor
        # raises inside the dispatch
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                         "__int__", "__float__"):
                m.setattr(torch.Tensor, name, _no_read_back(name))
            out, n48, stats = tiny_model.dispatch_generate(
                batch, [16000, 8000], 16000)
        assert stats is None  # the JAX package's third result, fixed grid
        assert isinstance(out, torch.Tensor) and out.shape == (2, 48000)
        assert n48.tolist() == [48000, 24000]
        # row 1 is the 0.5 s clip in a 1 s bucket, as generate pads it
        np.testing.assert_allclose(
            out[1:, :24000].numpy(),
            tiny_model.generate(audio[:8000], 16000), atol=1e-4)
        wired, _, _ = tiny_model.dispatch_generate(batch, [16000, 8000],
                                                   16000, wire="int16")
        assert wired.dtype == torch.int16
        with pytest.raises(ValueError, match="wire"):
            tiny_model.dispatch_generate(batch, [16000, 8000], 16000,
                                         wire="f8")

    def test_wire_int16_matches_jax(self):
        x = np.linspace(-1.2, 1.2, 4097, dtype=np.float32)
        x[:4] = [0.5 / 32767, 1.5 / 32767, -0.5 / 32767, -2.5 / 32767]
        want = np.asarray(jax_wire_int16(jnp.asarray(x)))
        got = _wire_int16(torch.from_numpy(x)).numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


# --- from_local ----------------------------------------------------------------------

FILE_VOCODER = dict(num_mels=256, upsample_initial_channel=32,
                    upsample_rates=(8, 5, 4, 3),
                    upsample_kernel_sizes=(16, 11, 8, 7),
                    resblock_kernel_sizes=(3, 7),
                    resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """The published checkpoint layout, written from reference-layout
    modules: the weight-normed generator, the vector field under the
    ``flowhigh.`` prefix (plus an embedded vocoder copy, as the published
    model file has), and the vocoder's JSON config."""
    d = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    voc = torch_ref.TorchBigVGAN(pcfg.VocoderConfig(**FILE_VOCODER)).eval()
    with torch.no_grad():
        for name, prm in voc.named_parameters():
            if name.endswith((".alpha", ".beta", ".bias")):
                prm.normal_(0.0, 0.1)
    torch.save({"generator": torch_ref.torch_state_dict_weight_normed(voc)},
               d / "bigvgan_48khz_256band.pt")
    wrap = torch_ref.TorchCFMWrapper(**{k: TINY_MODEL[k] for k in (
        "dim_in", "dim", "depth", "dim_head", "heads")}).eval()
    with torch.no_grad():
        for prm in wrap.parameters():
            prm.add_(0.02 * torch.randn_like(prm))
    sd = dict(wrap.state_dict())
    sd["flowhigh.audio_enc_dec.vocoder.conv_pre.weight"] = torch.zeros(1)
    torch.save({"model": sd, "optim": {}, "scheduler": {}},
               d / "FLowHigh_basic_400k.pt")
    (d / "bigvgan_48khz_256band.json").write_text(json.dumps(
        {**FILE_VOCODER, "upsample_rates": list(FILE_VOCODER["upsample_rates"]),
         "resblock_dilation_sizes": [list(x) for x in
                                     FILE_VOCODER["resblock_dilation_sizes"]],
         "resblock": "1", "activation": "snakebeta", "snake_logscale": True,
         "sampling_rate": 48000}))
    return d, voc, wrap.flowhigh


class TestFromLocal:
    def _load(self, d, **kw):
        return FlowHighSR.from_local(
            d, device="cpu", model_config=pcfg.ModelConfig(**TINY_MODEL),
            cfm_method="independent_cfm_adaptive", ode_method="euler", **kw)

    def test_loads_the_reference_files(self, ckpt_dir, rng):
        d, voc, net = ckpt_dir
        sr = self._load(d)
        assert sr.config.vocoder == pcfg.VocoderConfig(**FILE_VOCODER)
        assert sr.cfm_method == "independent_cfm_adaptive"
        mel = torch.from_numpy(rng.standard_normal((1, 6, 256)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((1, 6, 256)).astype(np.float32))
        times = torch.tensor([0.3])
        with torch.no_grad():
            torch.testing.assert_close(sr.vocoder(mel),
                                       voc(mel.transpose(1, 2))[:, 0, :],
                                       atol=1e-4, rtol=0)
            torch.testing.assert_close(sr.net(x, times=times, cond=mel),
                                       net(x, times, mel), atol=1e-4, rtol=1e-4)
        out = sr.generate(_clip(rng, 8000), 8000)
        assert out.shape == (1, 48000) and np.isfinite(out).all()

    def test_defaults_and_missing_tensors(self, ckpt_dir, tmp_path):
        d, _, _ = ckpt_dir
        sr = FlowHighSR.from_local(
            d, device="cpu", model_config=pcfg.ModelConfig(**TINY_MODEL))
        assert sr.cfm_method == "basic_cfm"  # the JAX package's default
        pkg = torch.load(d / "FLowHigh_basic_400k.pt", weights_only=True)
        del pkg["model"]["flowhigh.to_pred.weight"]
        for name in ("bigvgan_48khz_256band.pt", "bigvgan_48khz_256band.json"):
            (tmp_path / name).write_bytes((d / name).read_bytes())
        torch.save(pkg, tmp_path / "FLowHigh_basic_400k.pt")
        with pytest.raises(KeyError, match="to_pred"):
            self._load(tmp_path)
