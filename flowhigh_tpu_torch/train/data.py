"""Training data pipeline — counterpart of ``flowhigh_tpu/train/data.py``:
on-the-fly degradation on host workers.

The reference degrades each clip inside dataloader workers — random target
rate in {4k..32k step 1k}, random Chebyshev-I order 1-11 / ripple from a
fixed set (train) or order 8 / ripple 0.05 (valid), sosfiltfilt, down+up
resample_poly, length-matched (reference: src/flowhigh/train/data.py:92-131).
Filter design is data-dependent per clip, so this stays host-side (like the
reference's 8 numpy workers, here through the native C++ chain,
``flowhigh_tpu_torch.native``); batches can be uploaded to the card from
the prefetch threads (``batch_iterator(device_prefetch=True)``).

Everything before the upload is numpy and scipy, the JAX package's code, so
the datasets and batches equal that package's. WAV IO uses scipy; a
synthetic dataset generates harmonic clips for tests and data-free runs.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import scipy.io.wavfile as wavfile
import torch

from ..config import DataConfig
from ..dsp.filters import host_degrade

RIPPLES = (1e-9, 1e-6, 1e-3, 1, 5)  # (reference: data.py:109)


def load_wav_mono(path, keep_int16: bool = False) -> tuple[np.ndarray, int]:
    """Read a wav as mono float32 in [-1, 1] (int16 / 32768, int32 /
    2^31, uint8 centred at 128; stereo averaged). With ``keep_int16=True``
    a mono 16-bit file comes back as raw int16: ``FlowHighSR.generate`` and
    ``ServingPipeline.submit`` upload it as int16 and divide by 32768 on the
    device, bit-identical to the float path. Stereo int16 still converts
    (the channel mean is not int16)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        if keep_int16 and data.ndim == 1:
            return data, sr
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=1)
    return wave, sr


class AudioDataset:
    """Glob **/*.wav + per-item degradation (reference: data.py:23-131)."""

    def __init__(self, folder, cfg: DataConfig = DataConfig(), mode: Optional[str] = None,
                 audio_extension: str = ".wav"):
        path = Path(folder)
        assert path.exists(), "folder does not exist"
        self.files = sorted(path.glob(f"**/*{audio_extension}"))
        assert len(self.files) > 0, "no files found"
        self.cfg = cfg
        self.mode = mode

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng()
        wave, sr = load_wav_mono(self.files[idx])
        return degrade_item(wave, sr, self.cfg, self.mode, rng)


def degrade_item(wave: np.ndarray, sr: int, cfg: DataConfig, mode: Optional[str],
                 rng: np.random.Generator) -> dict:
    wave = wave / (np.abs(wave).max() + 1e-12)
    rates = np.arange(cfg.downsample_min, cfg.downsample_max + cfg.downsample_step,
                      cfg.downsample_step)
    random_sr = int(rng.choice(rates))
    if mode == "valid":
        order, ripple = 8, 0.05
    else:
        order = int(rng.integers(1, 12))
        ripple = float(rng.choice(RIPPLES))
    cond = host_degrade(wave.astype(np.float64), sr, random_sr, order, ripple)
    return {
        "wave": wave.astype(np.float32),
        "length": len(wave),
        "cond": cond.astype(np.float32),
        "random_sr": random_sr,
    }


class SyntheticAudioDataset:
    """Data-free stand-in: random harmonic complexes at 48 kHz. Same item
    schema as AudioDataset, for tests/benches without a corpus."""

    def __init__(self, cfg: DataConfig = DataConfig(), n_items: int = 64,
                 seconds: float = 3.0, seed: int = 0, mode: Optional[str] = None):
        self.cfg = cfg
        self.n_items = n_items
        self.seconds = seconds
        self.seed = seed
        self.mode = mode

    def __len__(self):
        return self.n_items

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        sr = self.cfg.sampling_rate
        n = int(sr * self.seconds)
        t = np.arange(n) / sr
        f0 = rng.uniform(80, 300)
        wave = np.zeros(n)
        for k in range(1, 12):
            if f0 * k < sr / 2:
                wave += rng.uniform(0.2, 1.0) / k * np.sin(
                    2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
        wave += 0.01 * rng.standard_normal(n)
        return degrade_item(wave.astype(np.float32), sr, self.cfg, self.mode, rng)


def collate(items: list[dict], pad_to_longest: bool = True) -> dict:
    """Pad-to-longest collate (reference: data.py:136-167)."""
    if pad_to_longest:
        t = max(it["length"] for it in items)
    else:
        t = min(it["length"] for it in items)
    b = len(items)
    wave = np.zeros((b, t), np.float32)
    cond = np.zeros((b, t), np.float32)
    for i, it in enumerate(items):
        n = min(it["length"], t)
        wave[i, :n] = it["wave"][:n]
        cond[i, :n] = it["cond"][:n]
    return {
        "wave": wave,
        "cond": cond,
        "lengths": np.array([min(it["length"], t) for it in items], np.int32),
        "random_sr": np.array([it["random_sr"] for it in items], np.int32),
    }


_POOL_DS = None  # per-worker-process dataset (set once by _pool_init)


def _pool_init(ds):
    global _POOL_DS
    _POOL_DS = ds


def _pool_item(i: int) -> dict:
    return _POOL_DS[i]


class _Uploader:
    """Moves collated batches to ``device`` from the prefetch threads.

    On the card: a ring of pinned host buffers (one a producer thread,
    reused while a batch's shapes stay the same), the copies on a side
    stream, and an event recorded after each; the producer waits for its
    copy before it returns the buffer to the ring, and the consumer's
    stream waits on the event (``handover``). On the CPU the arrays become
    tensors without a copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.ring: queue.Queue = queue.Queue()
        for _ in range(slots):
            self.ring.put({})
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def upload(self, batch: dict):
        if not self.cuda:
            return {k: torch.from_numpy(v) for k, v in batch.items()}, None
        slot = self.ring.get()
        try:
            for k, v in batch.items():
                src = torch.from_numpy(v)
                buf = slot.get(k)
                if buf is None or buf.shape != src.shape \
                        or buf.dtype != src.dtype:
                    buf = slot[k] = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
                buf.copy_(src)
            with torch.cuda.stream(self.stream):
                out = {k: slot[k].to(self.device, non_blocking=True)
                       for k in batch}
                done = torch.cuda.Event()
                done.record(self.stream)
            done.synchronize()  # the pinned slot may be refilled now
        finally:
            self.ring.put(slot)
        return out, done

    def handover(self, batch: dict, done) -> dict:
        """Order the consumer's current stream after the batch's copy, and
        tell the allocator that the tensors are used there."""
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch


def batch_iterator(
    ds, batch_size: int, seed: int = 0, pad_to: Optional[int] = None,
    num_workers: int = 2, prefetch: int = 4, device_prefetch: bool = False,
    process_index: int = 0, process_count: int = 1,
    worker_type: str = "thread", device=None,
) -> Iterator[dict]:
    """Infinite shuffled batches with threaded host-side prefetch.

    ``pad_to``: crop every longer clip to ``pad_to`` samples and zero-pad
    every shorter one, as the JAX package does; a padded clip keeps its
    length, so ``collate`` cuts a batch of short clips back to the longest
    (clips of ``pad_to`` samples or more give one shape).

    ``device_prefetch``: additionally upload each batch to ``device`` (which
    must then be given) from the prefetch threads, through pinned buffers
    and a side stream, so that the host->device copy overlaps the running
    train step; the batch then holds tensors on ``device``
    (``Trainer.train_step`` takes them without another copy). Otherwise
    the batch holds numpy arrays.

    ``process_index``/``process_count``: multi-process data sharding (the
    reference's DistributedSampler analog, via Accelerate's prepared
    dataloader). ``batch_size`` is the GLOBAL batch; every process draws the
    SAME global index sample (shared seed) and keeps only its own
    ``batch_size/process_count`` rows — disjoint, statically-shaped local
    shards.

    ``worker_type``: ``"thread"`` (default) or ``"process"``. The
    degradation is native or scipy C code that releases the GIL, so
    threads scale with the host's cores; ``"process"`` farms item
    degradation to a spawn-context worker pool (the reference's 8
    dataloader processes, reference data.py:169-171) with two coordinator
    threads; the dataset must be picklable (AudioDataset /
    SyntheticAudioDataset are, and hold no tensors). Each producer thread
    ``wid`` draws from ``np.random.default_rng(seed * 7919 + wid)``.
    """
    assert batch_size % max(process_count, 1) == 0, (
        f"global batch {batch_size} must divide over {process_count} processes")
    rows = slice((batch_size // process_count) * process_index,
                 (batch_size // process_count) * (process_index + 1))
    if device_prefetch and device is None:
        raise ValueError("batch_iterator: device_prefetch=True needs device=")

    if worker_type == "process":
        n_threads = 2  # coordinators: draw indices, collate, upload
    elif worker_type == "thread":
        n_threads = max(1, num_workers)
    else:
        raise ValueError(f"worker_type must be 'thread' or 'process', "
                         f"got {worker_type!r}")
    uploader = (_Uploader(torch.device(device), n_threads)
                if device_prefetch else None)
    pool = None
    if worker_type == "process":
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            max_workers=max(1, num_workers),
            mp_context=mp.get_context("spawn"),
            initializer=_pool_init, initargs=(ds,))

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def make_batch(rng: np.random.Generator):
        # the full global draw, identical on every process (same seed), so
        # the per-process row slices are disjoint by construction
        idx = rng.choice(len(ds), size=batch_size, replace=len(ds) < batch_size)
        local = [int(i) for i in idx[rows]]
        if pool is not None:
            items = list(pool.map(_pool_item, local,
                                  chunksize=max(1, len(local) // (
                                      2 * max(1, num_workers)))))
        else:
            items = []
            for i in local:
                if stop.is_set():  # closed: drop the batch, stop promptly
                    return None
                items.append(ds[i])
        if pad_to is not None:
            for it in items:
                n = len(it["wave"])
                if n >= pad_to:
                    it["wave"] = it["wave"][:pad_to]
                    it["cond"] = it["cond"][:pad_to]
                    it["length"] = pad_to
                else:
                    it["wave"] = np.pad(it["wave"], (0, pad_to - n))
                    it["cond"] = np.pad(it["cond"], (0, pad_to - n))
        batch = collate(items)
        if uploader is not None:
            return uploader.upload(batch)  # overlaps the running step
        return batch, None

    def worker(wid: int):
        rng = np.random.default_rng(seed * 7919 + wid)  # per-thread generator
        while not stop.is_set():
            try:
                batch = make_batch(rng)
            except Exception as e:  # surface in the consumer, don't hang it
                batch = e
            if batch is None:
                return
            while not stop.is_set():
                try:
                    q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_threads)]
    for th in threads:
        th.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            batch, done = item
            yield uploader.handover(batch, done) if uploader else batch
    finally:
        stop.set()
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


class Subset:
    """Index-remapped view of a dataset (torch.utils.data.Subset analog)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]


def random_split(dataset, valid_frac: float, seed: int = 53):
    """Seeded train/valid split (reference: trainer.py:118-129 —
    ``random_split(ds, [train, valid], generator=manual_seed(53))``).
    Returns (train_subset, valid_subset); deterministic for a given seed and
    the JAX package's split, but NOT item-identical to torch's
    ``generator(53)`` split (numpy's permutation consumes randomness
    differently) — don't expect matching train/valid membership when
    comparing runs against the reference."""
    n = len(dataset)
    train_size = int((1 - valid_frac) * n)
    perm = np.random.default_rng(seed).permutation(n)
    return (Subset(dataset, perm[:train_size]),
            Subset(dataset, perm[train_size:]))


class VocoderSegmentDataset:
    """Random fixed-length 48 kHz segments for vocoder GAN training
    (reference: src/flowhigh/models/bigvgan/meldataset.py:99-202 — the mel
    pair is computed on device by the vocoder trainer, not here)."""

    def __init__(self, source, segment_samples: int = 15360, seed: int = 0):
        """``source``: an AudioDataset/SyntheticAudioDataset-like object whose
        items have a 48 kHz 'wave' field."""
        self.source = source
        self.segment_samples = segment_samples
        self.seed = seed

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 99991 + idx)
        wave = self.source[idx]["wave"]
        n = self.segment_samples
        if len(wave) >= n:
            start = int(rng.integers(0, len(wave) - n + 1))
            seg = wave[start : start + n]
        else:
            seg = np.pad(wave, (0, n - len(wave)))
        return {"wave": seg.astype(np.float32), "length": n,
                "cond": seg.astype(np.float32), "random_sr": 48000}


def scan_checkpoints(folder, prefix: str = "FLowHigh."):
    """Latest torch-layout checkpoint in a results folder
    (reference: src/flowhigh/models/bigvgan/utils.py:57-76)."""
    cands = sorted(Path(folder).glob(f"{prefix}*.pt"),
                   key=lambda p: int("".join(filter(str.isdigit, p.stem)) or 0))
    return cands[-1] if cands else None
