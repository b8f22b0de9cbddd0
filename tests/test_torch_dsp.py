"""flowhigh_tpu_torch DSP against the JAX package: polyphase resampling,
STFT / iSTFT and the log-mel encode, on numpy-seeded inputs (CPU)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowhigh_tpu.dsp import mel_filterbank as jax_mel_filterbank
from flowhigh_tpu.dsp import resample_poly as jax_resample_poly
from flowhigh_tpu.dsp import stft as jax_stft
from flowhigh_tpu.models.melvoco import encode as jax_encode
from flowhigh_tpu_torch.dsp import istft, mel_filterbank, resample_poly, stft
from flowhigh_tpu_torch.models import mel_encode

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.mark.parametrize("sr", [16000, 8000, 44100])
def test_resample_poly_matches_jax(rng, sr):
    x = (rng.standard_normal((2, sr // 4)) * 0.3).astype(np.float32)
    want = np.asarray(jax_resample_poly(jnp.asarray(x), 48000, sr))
    got = resample_poly(torch.from_numpy(x), 48000, sr).numpy()
    assert got.shape == want.shape
    # both are one f32 conv with the same polyphase bank; sums reassociate
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mel_filterbank_matches_jax():
    np.testing.assert_array_equal(mel_filterbank(), jax_mel_filterbank())


@pytest.mark.parametrize("center,pad_mode", [(True, "constant"),
                                             (False, "reflect")])
def test_stft_matches_jax(rng, center, pad_mode):
    x = rng.standard_normal((1, 9600)).astype(np.float32)
    want = np.asarray(jax_stft(jnp.asarray(x), 2048, 480, 2048, center,
                               pad_mode))
    got = stft(torch.from_numpy(x), 2048, 480, 2048, center, pad_mode).numpy()
    assert got.shape == want.shape
    # FFT vs the JAX package's f32 DFT matmul over 2048 taps: relative to
    # the spectrum's scale, f32 rounding of 2048-term sums
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_stft_istft_round_trip(rng):
    x = torch.from_numpy(rng.standard_normal((2, 12000)).astype(np.float32))
    y = istft(stft(x, 2048, 480, 2048, True, "constant"), 2048, 480, 2048,
              length=12000)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-5)


def test_encode_matches_jax(rng):
    # a band-limited clip like generate's input: 8 kHz content at 48 kHz, so
    # the upper bins sit near the 1e-5 log clamp where f32 differs most
    x = (rng.standard_normal((1, 16000)) * 0.3).astype(np.float32)
    x48 = resample_poly(torch.from_numpy(x), 48000, 16000)
    want = np.asarray(jax_encode(jnp.asarray(x48.numpy())))
    got = mel_encode(x48).numpy()
    assert got.shape == want.shape == (1, 100, 256)
    # f64 FFT vs the JAX package's f32 DFT matmul, compared in the log
    # domain, where bins near the 1e-5 clamp carry the f32 DFT's rounding
    np.testing.assert_allclose(got, want, atol=1e-3)
