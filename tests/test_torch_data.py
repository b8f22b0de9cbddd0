"""The port's training data (``flowhigh_tpu_torch.native``, ``dsp.filters``,
``train.data``) against the JAX package's on the CPU.

The native host DSP is the same C++ source built by the same flags, so its
results equal ``flowhigh_tpu.native``'s bit for bit, and both equal scipy
within tests/test_native_dsp.py's tolerances over that file's cases. The
datasets, collation, split and batch iterators are the JAX package's numpy
code: equal arrays from the same seeds. The device ``sosfiltfilt`` runs its
plain version here (the loop over time in PyTorch; the sosfilt kernel is
held to it on the card in tests/test_torch_kernels.py): within 1e-4 of the
JAX ``lax.scan`` under ``jax.jit`` and 2e-3 of scipy (tests/test_dsp.py's
bound).
"""

import os

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import scipy.signal as sps
import torch

import jax
import jax.numpy as jnp

import flowhigh_tpu.dsp as jax_dsp
import flowhigh_tpu.train as jax_train
from flowhigh_tpu import native as jax_native
from flowhigh_tpu.config import DataConfig as JaxDataConfig
from flowhigh_tpu.dsp.filters import host_degrade as jax_host_degrade
from flowhigh_tpu.train import data as jax_data
from flowhigh_tpu_torch import dsp, native
from flowhigh_tpu_torch import train as ptrain
from flowhigh_tpu_torch.config import DataConfig, FlowHighConfig
from flowhigh_tpu_torch.dsp import filters
from flowhigh_tpu_torch.native import build as native_build
from flowhigh_tpu_torch.ops.iir import cascade, sosfilt_plain
from flowhigh_tpu_torch.train import data as pdata

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

needs_native = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="native DSP library unavailable (no g++?)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and torch's pool then spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng([1234, *key])


def _equal_items(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- the native host DSP ---------------------------------------------------------

@needs_native
class TestNative:
    @pytest.mark.parametrize("order", [1, 2, 3, 5, 8, 11])
    @pytest.mark.parametrize("ripple", [1e-9, 0.05, 5.0])
    def test_sosfiltfilt(self, order, ripple):
        sos = sps.cheby1(order, ripple, 0.21, btype="lowpass", output="sos")
        x = _rng(order, int(ripple * 100)).standard_normal(4000)
        ours = native.sosfiltfilt(sos, x)
        np.testing.assert_array_equal(ours, jax_native.sosfiltfilt(sos, x))
        ref = sps.sosfiltfilt(sos, x)
        np.testing.assert_allclose(ours, ref, rtol=1e-9,
                                   atol=1e-11 * np.abs(ref).max())

    def test_sosfiltfilt_at_and_above_padlen(self):
        sos = sps.cheby1(4, 0.1, 0.3, btype="lowpass", output="sos")
        edge = native._filtfilt_edge(np.asarray(sos, np.float64))
        x = _rng(1).standard_normal(edge + 1)
        np.testing.assert_array_equal(native.sosfiltfilt(sos, x),
                                      jax_native.sosfiltfilt(sos, x))
        np.testing.assert_allclose(native.sosfiltfilt(sos, x),
                                   sps.sosfiltfilt(sos, x), rtol=1e-9,
                                   atol=1e-9)
        with pytest.raises(ValueError):
            native.sosfiltfilt(sos, x[:edge])

    def test_sosfilt_zi(self):
        for order, ripple in [(1, 0.05), (4, 1.0), (11, 1e-6)]:
            sos = np.ascontiguousarray(sps.cheby1(
                order, ripple, 0.4, btype="lowpass", output="sos"), np.float64)
            zi = np.empty((sos.shape[0], 2))
            native._load().fh_sosfilt_zi(sos, sos.shape[0], zi)
            np.testing.assert_allclose(zi, sps.sosfilt_zi(sos), rtol=1e-12,
                                       atol=1e-14)

    @pytest.mark.parametrize("rate", list(range(4000, 33000, 1000)))
    def test_resample_poly_training_rates(self, rate):
        sr = 48000
        x = _rng(rate).standard_normal(9601)
        dn = native.resample_poly(x, rate, sr)
        np.testing.assert_array_equal(dn, jax_native.resample_poly(x, rate, sr))
        np.testing.assert_allclose(dn, sps.resample_poly(x, rate, sr),
                                   rtol=1e-9, atol=1e-11)
        up = native.resample_poly(dn, sr, rate)
        np.testing.assert_array_equal(up, jax_native.resample_poly(dn, sr, rate))
        np.testing.assert_allclose(up, sps.resample_poly(dn, sr, rate),
                                   rtol=1e-9, atol=1e-11)

    @pytest.mark.parametrize("n", [37, 100, 481, 4801])
    def test_resample_poly_awkward_lengths(self, n):
        x = _rng(n).standard_normal(n)
        for up, down in [(3, 16), (16, 3), (1, 12), (12, 1), (31, 48)]:
            ours = native.resample_poly(x, up, down)
            np.testing.assert_array_equal(
                ours, jax_native.resample_poly(x, up, down))
            ref = sps.resample_poly(x, up, down)
            assert ours.shape == ref.shape, (n, up, down)
            np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-11)
        y = native.resample_poly(x, 7, 7)
        np.testing.assert_array_equal(x, y)
        assert y is not x

    CASES = [(4000, 1, 1e-9), (8000, 8, 0.05), (9000, 11, 5.0),
             (17000, 4, 1e-3), (31000, 5, 1.0), (32000, 3, 1e-6)]

    @pytest.mark.parametrize("rate,order,ripple", CASES)
    def test_host_degrade(self, rate, order, ripple):
        sr = 48000
        wave = _rng(rate, order).standard_normal(sr)
        ours = native.host_degrade(wave, sr, rate, order, ripple)
        np.testing.assert_array_equal(
            ours, jax_native.host_degrade(wave, sr, rate, order, ripple))
        ref = filters.host_degrade(wave, sr, rate, order, ripple,
                                   engine="scipy")
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-10)
        # the engines of the port against the JAX package's
        np.testing.assert_array_equal(ref, jax_host_degrade(
            wave, sr, rate, order, ripple, engine="scipy"))
        np.testing.assert_array_equal(
            filters.host_degrade(wave, sr, rate, order, ripple), ours)

    def test_auto_falls_back_and_native_raises(self, monkeypatch):
        wave = _rng(2).standard_normal(24000)
        want = filters.host_degrade(wave, 48000, 8000, 8, 0.05, engine="scipy")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_error", RuntimeError("simulated"))
        assert not native.available()
        np.testing.assert_array_equal(
            filters.host_degrade(wave, 48000, 8000, 8, 0.05, engine="auto"),
            want)
        with pytest.raises(native.NativeUnavailable):
            filters.host_degrade(wave, 48000, 8000, 8, 0.05, engine="native")

    def test_build_cache_override_and_name(self, monkeypatch, tmp_path):
        # the library goes into build/flowhigh_tpu_torch beside the package
        # unless FLOWHIGH_NATIVE_CACHE names another directory; its name
        # hashes the source, the flags and the host's CPU
        assert native_build.BUILD_DIR.parts[-2:] == ("build",
                                                     "flowhigh_tpu_torch")
        monkeypatch.setenv("FLOWHIGH_NATIVE_CACHE", str(tmp_path))
        so = native_build.build_library()
        assert so.parent == tmp_path and so.exists()
        assert native_build.build_library() == so  # memoised
        monkeypatch.setattr(native_build, "_host_cpu", lambda: b"another")
        assert native_build.build_library().name != so.name


# --- dsp.filters ---------------------------------------------------------------

def test_dsp_exports_every_name_of_the_jax_package():
    assert set(jax_dsp.__all__) <= set(dsp.__all__)
    assert set(jax_train.__all__) <= set(ptrain.__all__)


def test_package_and_models_export_every_name_of_the_jax_package():
    # ops and compat are left out by design: the JAX package's ops hold its
    # TPU packing, its compat the JAX parameter trees
    import flowhigh_tpu
    import flowhigh_tpu.models as jax_models
    import flowhigh_tpu_torch
    import flowhigh_tpu_torch.models as port_models
    assert set(flowhigh_tpu.__all__) <= set(flowhigh_tpu_torch.__all__)
    assert set(jax_models.__all__) <= set(port_models.__all__)
    assert isinstance(flowhigh_tpu_torch.__version__, str)


def test_framing_helpers_equal_the_jax_package():
    np.testing.assert_array_equal(dsp.hann_window(2048).numpy(),
                                  np.asarray(jax_dsp.hann_window(2048)))
    for n, center in [(48000, True), (48000, False), (2047, False)]:
        assert dsp.num_frames(n, 2048, 480, center) == \
            jax_dsp.num_frames(n, 2048, 480, center)
    x = _rng(3).standard_normal((2, 5000)).astype(np.float32)
    np.testing.assert_array_equal(
        dsp.frame_signal(torch.from_numpy(x), 2048, 480).numpy(),
        np.asarray(jax_dsp.frame_signal(jnp.asarray(x), 2048, 480)))


def test_cheby1_sos_equals_the_jax_package():
    for order, ripple, wn in [(1, 1e-9, 0.5), (8, 0.05, 1 / 3), (11, 5.0, 0.1)]:
        np.testing.assert_array_equal(dsp.cheby1_sos(order, ripple, wn),
                                      jax_dsp.cheby1_sos(order, ripple, wn))


# the plain loop costs ~0.4 s per 1,000 samples at order 11: 2 x 1,500.
# Tolerance against the JAX scan: 1e-4; at order 11, ripple 5 dB, cutoff
# 1/12 the poles amplify float32 rounding: on these inputs (max |y| 1.1)
# the JAX scan lies 1.0e-4 from scipy's float64 result and the plain
# version 1.7e-4, so the two float32 scans are held within 2e-4 there
# (test_plain_pass_is_the_scans_float32_arithmetic pins the plain
# version's arithmetic exactly)
@pytest.mark.parametrize("order,ripple,wn,atol", [
    (1, 1e-9, 0.5, 1e-4), (8, 0.05, 0.5, 1e-4), (11, 5.0, 1 / 12, 2e-4)])
def test_plain_sosfiltfilt_against_jax_and_scipy(order, ripple, wn, atol):
    sos = dsp.cheby1_sos(order, ripple, wn)
    x = (0.5 * _rng(order).standard_normal((2, 1500))).astype(np.float32)
    got = dsp.sosfiltfilt(sos, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(jax.jit(lambda v: jax_dsp.sosfiltfilt(sos, v))(
        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    np.testing.assert_allclose(got.numpy(), sps.sosfiltfilt(
        sos, x.astype(np.float64)), atol=2e-3, rtol=0)


@pytest.mark.parametrize("order", [4, 11])
def test_plain_pass_is_the_scans_float32_arithmetic(order):
    # flowhigh_tpu/dsp/filters.py:_sosfilt as written, every product and
    # sum rounded to float32 on its own (numpy float32 scalars): the plain
    # version, and so the sosfilt kernel, give these bits
    sos = dsp.cheby1_sos(order, 5.0, 1 / 12)
    coefs = cascade(sos, sps.sosfilt_zi(sos))
    x = (0.5 * _rng(9, order).standard_normal(120)).astype(np.float32)
    c = [[np.float32(v) for v in row] for row in coefs]
    z1 = [row[5] * x[0] for row in c]
    z2 = [row[6] * x[0] for row in c]
    want = []
    for v in x:
        for s, (b0, b1, b2, a1, a2, _, _) in enumerate(c):
            y = b0 * v + z1[s]
            z1[s] = b1 * v + z2[s] - a1 * y
            z2[s] = b2 * v - a2 * y
            v = y
        want.append(v)
    got = sosfilt_plain(coefs, torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_plain_pass_in_reverse_is_the_flipped_pass():
    sos = dsp.cheby1_sos(4, 1.0, 0.3)
    coefs = cascade(sos, sps.sosfilt_zi(sos))
    x = torch.from_numpy(_rng(4).standard_normal((3, 50)).astype(np.float32))
    torch.testing.assert_close(
        sosfilt_plain(coefs, x, reverse=True),
        sosfilt_plain(coefs, x.flip(-1)).flip(-1), atol=0, rtol=0)


def test_sosfiltfilt_refuses_input_within_padlen():
    sos = dsp.cheby1_sos(2, 1.0, 0.3)
    with pytest.raises(ValueError, match="padlen"):
        dsp.sosfiltfilt(sos, torch.zeros(1, filters.padlen(sos)))


# --- train.data ---------------------------------------------------------------

@pytest.mark.parametrize("mode", [None, "valid"])
def test_synthetic_items_equal_the_jax_package(mode):
    ours = ptrain.SyntheticAudioDataset(n_items=3, seconds=0.5, seed=2,
                                        mode=mode)
    theirs = jax_train.SyntheticAudioDataset(n_items=3, seconds=0.5, seed=2,
                                             mode=mode)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _equal_items(ours[i], theirs[i])


def test_degrade_item_and_collate_equal_the_jax_package():
    waves = [_rng(5, i).standard_normal(n).astype(np.float32)
             for i, n in enumerate((9000, 12000, 7000))]
    items = [pdata.degrade_item(w, 48000, DataConfig(), None, _rng(6, i))
             for i, w in enumerate(waves)]
    jitems = [jax_data.degrade_item(w, 48000, JaxDataConfig(), None,
                                    _rng(6, i))
              for i, w in enumerate(waves)]
    for a, b in zip(items, jitems):
        _equal_items(a, b)
        assert a["cond"].dtype == np.float32 and a["cond"].shape == a["wave"].shape
    for longest in (True, False):
        _equal_items(pdata.collate(items, longest),
                     jax_data.collate(jitems, longest))


def test_audio_dataset_reads_the_same_files(tmp_path):
    for i, n in enumerate((12000, 9000)):  # 48 kHz, int16
        sub = tmp_path / f"d{i}"
        sub.mkdir()
        wavfile.write(sub / f"c{i}.wav", 48000, (_rng(7, i).standard_normal(
            n) * 3000).astype(np.int16))
    ours = ptrain.AudioDataset(tmp_path)
    theirs = jax_train.AudioDataset(tmp_path)
    assert ours.files == theirs.files and len(ours) == 2
    for i in range(2):  # the degradation draws are unseeded, as there
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["wave"], b["wave"])
        assert a["cond"].shape == a["wave"].shape and a["length"] == b["length"]


def test_random_split_and_subset_equal_the_jax_package():
    ds = ptrain.SyntheticAudioDataset(n_items=40, seconds=0.2)
    jds = jax_train.SyntheticAudioDataset(n_items=40, seconds=0.2)
    for frac, seed in [(0.05, 53), (0.25, 7)]:
        tr, va = ptrain.random_split(ds, frac, seed)
        jtr, jva = jax_train.random_split(jds, frac, seed)
        assert tr.indices == jtr.indices and va.indices == jva.indices
        assert not set(tr.indices) & set(va.indices)
        assert sorted(tr.indices + va.indices) == list(range(40))
    _equal_items(tr[1], jtr[1])


def test_vocoder_segments_and_scan_checkpoints(tmp_path):
    src = ptrain.SyntheticAudioDataset(n_items=2, seconds=0.25)
    jsrc = jax_train.SyntheticAudioDataset(n_items=2, seconds=0.25)
    for n in (9600, 20000):  # a crop, then a zero pad
        ours = ptrain.VocoderSegmentDataset(src, segment_samples=n, seed=3)
        theirs = jax_train.VocoderSegmentDataset(jsrc, segment_samples=n,
                                                 seed=3)
        for i in range(2):
            _equal_items(ours[i], theirs[i])
    assert ptrain.scan_checkpoints(tmp_path) is None
    for step in [100, 2000, 50]:
        (tmp_path / f"FLowHigh.{step}.pt").touch()
    assert ptrain.scan_checkpoints(tmp_path) == \
        jax_train.scan_checkpoints(tmp_path)
    assert ptrain.scan_checkpoints(tmp_path).name == "FLowHigh.2000.pt"


def _take(it, n):
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


# pad_to below the clips' 19,200 samples crops them to one shape; above it
# the JAX package pads each clip but keeps its length, so that collate cuts
# the batch back to the longest length (the port keeps that)
@pytest.mark.parametrize("pad_to", [None, 12000, 20000])
def test_thread_batches_equal_the_jax_package(pad_to):
    ds = ptrain.SyntheticAudioDataset(n_items=6, seconds=0.4)
    jds = jax_train.SyntheticAudioDataset(n_items=6, seconds=0.4)
    ours = _take(ptrain.batch_iterator(ds, 3, seed=4, pad_to=pad_to,
                                       num_workers=1), 3)
    theirs = _take(jax_train.batch_iterator(jds, 3, seed=4, pad_to=pad_to,
                                            num_workers=1), 3)
    for a, b in zip(ours, theirs):
        _equal_items(a, b)
        assert a["wave"].shape == (3, min(pad_to or 19200, 19200))


def test_process_shards_are_disjoint_and_equal_the_jax_package():
    ds = ptrain.SyntheticAudioDataset(n_items=8, seconds=0.2)
    jds = jax_train.SyntheticAudioDataset(n_items=8, seconds=0.2)
    rows = []
    for p in range(2):
        ours = _take(ptrain.batch_iterator(ds, 4, seed=1, num_workers=1,
                                           process_index=p, process_count=2), 2)
        theirs = _take(jax_train.batch_iterator(
            jds, 4, seed=1, num_workers=1, process_index=p, process_count=2), 2)
        for a, b in zip(ours, theirs):
            _equal_items(a, b)
            assert a["wave"].shape[0] == 2
        rows.append(ours)
    # the same global draw, disjoint halves: the rows' (clip) waves differ
    draw = np.random.default_rng(1 * 7919).choice(8, size=4, replace=False)
    for b in range(2):
        got = np.concatenate([rows[0][b]["wave"], rows[1][b]["wave"]])
        if b == 0:
            want = pdata.collate([ds[int(i)] for i in draw])["wave"]
            np.testing.assert_array_equal(got, want)


def test_spawn_workers_give_their_coordinators_batches():
    # two coordinator threads draw indices; every batch equals the next
    # batch of one coordinator's generator (seed * 7919 + wid)
    ds = ptrain.SyntheticAudioDataset(n_items=10, seconds=0.2)
    got = _take(ptrain.batch_iterator(ds, 3, seed=2, num_workers=2,
                                      worker_type="process"), 4)
    rngs = [np.random.default_rng(2 * 7919 + w) for w in range(2)]
    expected = [[], []]
    for w, rng in enumerate(rngs):
        for _ in range(4):
            idx = rng.choice(10, size=3, replace=False)
            expected[w].append(pdata.collate([ds[int(i)] for i in idx]))
    pos = [0, 0]
    for batch in got:
        for w in range(2):
            want = expected[w][pos[w]]
            if all(np.array_equal(batch[k], want[k]) for k in batch):
                pos[w] += 1
                break
        else:
            raise AssertionError("a batch matches neither coordinator")


def test_batch_iterator_arguments():
    ds = ptrain.SyntheticAudioDataset(n_items=4, seconds=0.2)
    with pytest.raises(ValueError, match="device="):
        next(ptrain.batch_iterator(ds, 2, device_prefetch=True))
    with pytest.raises(ValueError, match="worker_type"):
        next(ptrain.batch_iterator(ds, 2, worker_type="fiber"))
    with pytest.raises(AssertionError, match="divide"):
        next(ptrain.batch_iterator(ds, 3, process_count=2))


def test_device_prefetch_gives_tensors_the_trainer_takes_without_a_copy():
    ds = ptrain.SyntheticAudioDataset(n_items=4, seconds=0.2)
    plain = _take(ptrain.batch_iterator(ds, 2, seed=3, pad_to=8000,
                                        num_workers=1), 2)
    moved = _take(ptrain.batch_iterator(ds, 2, seed=3, pad_to=8000,
                                        num_workers=1, device_prefetch=True,
                                        device="cpu"), 2)
    for a, b in zip(plain, moved):
        for k in a:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(a[k], b[k].numpy())
    tr = ptrain.Trainer(FlowHighConfig(), device="cpu")
    wave, cond, lengths = tr._batch(moved[0])
    assert wave.data_ptr() == moved[0]["wave"].data_ptr()
    assert cond.data_ptr() == moved[0]["cond"].data_ptr()
    assert lengths.dtype == torch.int64
