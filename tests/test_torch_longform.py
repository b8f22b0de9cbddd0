"""The port's long-form modes on the CPU: ``FlowHighSR.vocode_chunked`` and
``generate_longform`` (mirroring tests/test_metrics_streaming.py::
TestLongform), ``StreamingSR`` (mirroring TestStreaming) and the seam
metrics, against the port's own whole-clip paths and against the JAX
package. The JAX package's flash path runs its Pallas kernel in
TPU-interpret mode (``transformer.FLASH_INTERPRET``, set inside the test
and restored)."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flowhigh_tpu.models.transformer as JT
from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.metrics import boundary_lsd as jax_boundary_lsd
from flowhigh_tpu.metrics import log_spectral_distance as jax_lsd
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu.streaming import StreamingSR as JaxStreamingSR
from flowhigh_tpu_torch import (FlowHighSR, StreamingSR, boundary_lsd,
                                log_spectral_distance)
from flowhigh_tpu_torch import config as pcfg

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


@contextlib.contextmanager
def interpret():
    JT.FLASH_INTERPRET = True
    try:
        yield
    finally:
        JT.FLASH_INTERPRET = False


def _pair(attn_flash: bool):
    """The JAX package's FlowHighSR (sigma 0: a deterministic prior) and the
    port with the same weights, as tests/test_torch_serving.py builds them."""
    cj = jcfg.FlowHighConfig().replace(
        model=jcfg.ModelConfig(**TINY_MODEL, attn_flash=attn_flash),
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
    pc = pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**TINY_MODEL, attn_flash=attn_flash),
        vocoder=pcfg.VocoderConfig(**TINY_VOCODER))
    psr = FlowHighSR(pc, jax.device_get(jsr.params), jsr.melvoco.vocoder_params,
                     cfm_method="independent_cfm_adaptive", ode_method="euler",
                     device="cpu")
    return jsr, psr


@pytest.fixture(scope="module")
def flash_pair():
    return _pair(True)


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(False)


def _clip(rng, seconds, sr=16000, scale=0.3):
    return (rng.standard_normal(int(seconds * sr)) * scale).astype(np.float32)


# --- vocode_chunked, generate_longform ------------------------------------------

@pytest.mark.parametrize("chunk,overlap", [(16, 8), (20, 12), (30, 16),
                                          (64, 8)])
def test_vocode_chunked_matches_whole_vocoder(flash_pair, rng, chunk, overlap):
    # (64, 8): 64 frames fit one 80-frame window, the whole decode
    _, psr = flash_pair
    mel = torch.from_numpy(rng.standard_normal((1, 64, 256)).astype(np.float32))
    with torch.inference_mode():
        full = psr.vocoder(mel)
    chunked = psr.vocode_chunked(mel, chunk_frames=chunk,
                                 overlap_frames=overlap)
    assert isinstance(chunked, torch.Tensor) and chunked.shape == full.shape
    torch.testing.assert_close(chunked, full, atol=1e-5, rtol=0)


def test_vocode_chunked_matches_jax(flash_pair, rng):
    jsr, psr = flash_pair
    mel = rng.standard_normal((1, 64, 256)).astype(np.float32)
    want = jsr.vocode_chunked(jnp.asarray(mel), chunk_frames=16,
                              overlap_frames=8)
    got = psr.vocode_chunked(mel, chunk_frames=16, overlap_frames=8).numpy()
    assert got.shape == want.shape
    # as tests/test_torch_sr.py::test_bigvgan_matches_jax
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_generate_longform_matches_jax(flash_pair, rng):
    """6.5 s: a 7 s bucket of 700 frames, two 512 blocks, masked frames."""
    jsr, psr = flash_pair
    audio = _clip(rng, 6.5)
    kw = dict(timestep=1, seed=5, vocoder_chunk_frames=256,
              vocoder_overlap_frames=32)
    with interpret():
        want = jsr.generate_longform(audio, 16000, **kw)
    got = psr.generate_longform(audio, 16000, **kw)
    assert got.shape == want.shape == (1, 312000)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_generate_longform_matches_generate(flash_pair, rng):
    # on a clip generate runs whole, the only difference is the windowed
    # vocoder, which is exact: any deviation is a seam bug
    _, psr = flash_pair
    audio = _clip(rng, 4.0)
    whole = psr.generate(audio, 16000, timestep=1, seed=5)
    lf = psr.generate_longform(audio, 16000, timestep=1, seed=5,
                               vocoder_chunk_frames=96,
                               vocoder_overlap_frames=32)
    assert lf.shape == whole.shape
    np.testing.assert_allclose(lf, whole, atol=2e-4)


def test_generate_longform_input_conventions(flash_pair, rng):
    _, psr = flash_pair
    pcm = (rng.standard_normal(16000) * 8000).astype(np.int16)
    kw = dict(vocoder_chunk_frames=40, vocoder_overlap_frames=8)
    ref = psr.generate_longform(pcm.astype(np.float32) / 32768.0, 16000, **kw)
    np.testing.assert_array_equal(psr.generate_longform(pcm, 16000, **kw), ref)
    np.testing.assert_array_equal(
        psr.generate_longform(pcm[None].astype(np.float32), 16000, **kw), ref)


# --- StreamingSR (tests/test_metrics_streaming.py::TestStreaming) -----------------

class TestStreaming:
    def test_long_clip_stitches(self, flash_pair, rng):
        _, psr = flash_pair
        s = StreamingSR(psr, chunk_seconds=1.0, overlap_seconds=0.25)
        out = s.generate(_clip(rng, 3.0), 16000)
        assert out.shape == (1, 48000 * 3) and out.dtype == np.float32
        assert np.isfinite(out).all()
        # energy everywhere (no dead zones at chunk boundaries)
        seg = out[0].reshape(-1, 4800)
        assert (np.abs(seg).max(axis=1) > 1e-4).all()

    def test_short_clip_passthrough(self, flash_pair, rng):
        _, psr = flash_pair
        s = StreamingSR(psr, chunk_seconds=2.0, overlap_seconds=0.25)
        audio = _clip(rng, 1.0)
        np.testing.assert_array_equal(s.generate(audio, 16000, seed=0),
                                      psr.generate(audio, 16000, seed=0))

    def test_int16_wire_matches_float(self, flash_pair, rng):
        _, psr = flash_pair
        kw = dict(chunk_seconds=1.0, overlap_seconds=0.25)
        audio = _clip(rng, 3.0)
        ref = StreamingSR(psr, **kw).generate(audio, 16000, seed=3)
        got = StreamingSR(psr, wire="int16", **kw).generate(audio, 16000,
                                                            seed=3)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4)
        with pytest.raises(ValueError, match="wire"):
            StreamingSR(psr, wire="f8")

    def test_int16_input_wire_bit_matches_float(self, flash_pair, rng):
        _, psr = flash_pair
        s = StreamingSR(psr, chunk_seconds=1.0, overlap_seconds=0.25,
                        batch_size=2)
        pcm = (rng.standard_normal(16000 * 3) * 8000).astype(np.int16)
        ref = s.generate(pcm.astype(np.float32) / 32768.0, 16000, seed=4)
        np.testing.assert_array_equal(s.generate(pcm, 16000, seed=4), ref)
        # int16 in and out: still pure quantisation
        got = StreamingSR(psr, wire="int16", chunk_seconds=1.0,
                          overlap_seconds=0.25, batch_size=2).generate(
                              pcm, 16000, seed=4)
        assert np.abs(got - ref).max() <= 0.51 / 32767.0

    def test_batches_of_chunks_match_single_chunks(self, flash_pair, rng):
        # a batch of two against one chunk: matmuls of another height
        _, psr = flash_pair
        audio = _clip(rng, 3.0)
        kw = dict(chunk_seconds=1.0, overlap_seconds=0.25)
        np.testing.assert_allclose(
            StreamingSR(psr, batch_size=3, **kw).generate(audio, 16000),
            StreamingSR(psr, **kw).generate(audio, 16000), atol=1e-4)

    def test_validation(self, flash_pair):
        _, psr = flash_pair
        with pytest.raises(ValueError, match="pipeline_depth"):
            StreamingSR(psr, pipeline_depth=0)
        with pytest.raises(ValueError, match="overlap_seconds"):
            StreamingSR(psr, chunk_seconds=2.0, overlap_seconds=1.0)
        # generate_sharded is ported: a clip of one chunk is generate
        from flowhigh_tpu_torch.parallel import make_mesh as port_make_mesh
        clip = np.full(16000, 0.1, np.float32)
        np.testing.assert_array_equal(
            StreamingSR(psr).generate_sharded(clip, 16000, port_make_mesh()),
            psr.generate(clip, 16000))

    def test_matches_jax(self, dense_pair, rng):
        jsr, psr = dense_pair
        audio = _clip(rng, 3.0)
        kw = dict(chunk_seconds=1.0, overlap_seconds=0.25)
        want = JaxStreamingSR(jsr, **kw).generate(audio, 16000, seed=2)
        got = StreamingSR(psr, **kw).generate(audio, 16000, seed=2)
        assert got.shape == want.shape == (1, 144000)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_streaming_seam_lsd(self, flash_pair, rng):
        """Boundary-window LSD of the crossfaded chunks against the
        single-pass output, with tests/test_metrics_streaming.py's bound."""
        _, psr = flash_pair
        sr_in = 16000
        audio = _clip(rng, 5.0)
        single = psr.generate_longform(audio, sr_in, timestep=1, seed=0,
                                       vocoder_chunk_frames=128,
                                       vocoder_overlap_frames=32)
        streamed = StreamingSR(psr, chunk_seconds=2.0,
                               overlap_seconds=0.5).generate(audio, sr_in)
        assert streamed.shape == single.shape
        hop_in = int(2.0 * sr_in) - int(0.5 * sr_in)
        n_chunks = 1 + int(np.ceil((len(audio) - 2.0 * sr_in) / hop_in))
        boundaries = [c * hop_in * 3 for c in range(1, n_chunks)]
        seam = boundary_lsd(single, streamed, boundaries, window=24000)
        overall = float(log_spectral_distance(single, streamed)[0])
        assert np.isfinite(seam) and np.isfinite(overall)
        assert seam < max(2.0, 2.5 * overall), (seam, overall)


# --- metrics ------------------------------------------------------------------------

def test_lsd_matches_jax(rng):
    ref = rng.standard_normal((2, 24000)).astype(np.float32)
    est = (ref + 0.3 * rng.standard_normal((2, 24000))).astype(np.float32)
    want = np.asarray(jax_lsd(jnp.asarray(ref), jnp.asarray(est)))
    got = log_spectral_distance(ref, est).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert float(log_spectral_distance(ref, ref)[0]) < 1e-5


def test_boundary_lsd_matches_jax(rng):
    ref = rng.standard_normal(96000).astype(np.float32)
    est = ref.copy()
    est[40000:60000] += 0.5 * rng.standard_normal(20000).astype(np.float32)
    # the last window is too short to count
    bounds = [30000, 50000, 95500]
    want = jax_boundary_lsd(ref[None], est[None], bounds, window=12000)
    got = boundary_lsd(ref[None], est[None], bounds, window=12000)
    assert got > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert boundary_lsd(ref, est, [], window=12000) == 0.0
