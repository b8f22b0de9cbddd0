"""Sustained concurrent-clip serving: ``submit() -> Future``; counterpart of
``flowhigh_tpu/serving.py:ServingPipeline``.

Three threads (``pipeline.StagePipeline``) keep several clips in flight so
that one clip's host-to-device copy, another's compute and a third's
device-to-host copy overlap:

    submit() -> [uploader: pad into a pinned host buffer, copy to the card
                 on the upload stream, record an event]
             -> [dispatcher: the compute stream waits on that event, then
                 ``FlowHighSR._generate_impl`` is queued on it under
                 ``torch.inference_mode()``; record a done event]
             -> [fetcher: wait for the done event, copy to the host, trim,
                 resolve the Future]

``inference_mode`` and the current CUDA stream are thread-local, so the
dispatcher sets both itself. On the fixed grid ``_generate_impl`` reads
nothing back from the device (the output length is computed on the host),
so the dispatcher never waits for the card and can queue the next clip
while this one computes. A model built with ``ode_method="adaptive"``
makes the dispatcher wait on the device once per solver loop
(``cfm.odeint_adaptive``); its statistics ride to the fetcher, which
warns after the clip is done if an item did not converge, as the JAX
package's fetcher does.

    with ServingPipeline(model) as srv:
        futs = [srv.submit(a, 16000) for a in clips]
        outs = [f.result() for f in futs]

Each request is padded to the same 1 s output buckets as
``FlowHighSR.generate`` and runs alone (B = 1). On the CPU (``device="cpu"``
models, the tests) the same threads run with plain tensors and no streams.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from .pipeline import StagePipeline
from .sr import (FlowHighSR, _warn_if_unconverged, _wire_int16, padded_length,
                 prepare_clip, valid_samples_48k)


def request_seed(seed: int, index: int) -> int:
    """The seed of request ``index`` of a pipeline built with ``seed``: a
    64-bit word mixed from both by ``numpy.random.SeedSequence``, so every
    request draws independent prior noise. (The JAX package folds the index
    into its key with ``jax.random.fold_in``; JAX's and PyTorch's generators
    give different numbers anyway, so the rule here is the port's own.)"""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0] >> 1)


class ServingPipeline:
    def __init__(self, model: FlowHighSR, max_in_flight: int = 8,
                 wire: str = "float32", target_sampling_rate: int = 48000,
                 timestep: int = 1, seed: int = 0):
        """``max_in_flight`` bounds the clips dispatched to the card but not
        yet fetched (device memory backpressure).

        ``wire='int16'`` downloads waveforms quantised to int16 on the
        device (``sr._wire_int16``): half the device-to-host bytes; results
        are converted back to float32 (error <= 0.5 / 32767 per sample).

        ``seed`` salts the per-request generators: request i (in submission
        order) draws from a generator seeded with ``request_seed(seed, i)``
        unless ``submit(..., seed=s)`` pins ``s``, which gives exactly
        ``model.generate(audio, sr, seed=s)``."""
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        if wire not in ("float32", "int16"):
            raise ValueError(f"wire must be 'float32' or 'int16', got {wire!r}")
        self.model = model
        self.wire = wire
        self.target_sampling_rate = int(target_sampling_rate)
        self.timestep = int(timestep)
        self.seed = int(seed)
        self._n_submitted = 0
        self._closed = False
        self._lock = threading.Lock()
        self._cuda = model.device.type == "cuda"
        if self._cuda:
            self._upload_stream = torch.cuda.Stream(model.device)
            self._compute_stream = torch.cuda.Stream(model.device)
            # the weights were written on the caller's stream
            self._compute_stream.wait_stream(
                torch.cuda.current_stream(model.device))
        self._pipe = StagePipeline(
            [self._upload, self._dispatch, self._fetch],
            depths=[4, max_in_flight])

    # -- request side -----------------------------------------------------

    def submit(self, audio: np.ndarray, sr: int,
               seed: Optional[int] = None) -> Future:
        """[T] or [1, T] waveform at ``sr`` -> Future of [1, T'] float32 at
        ``target_sampling_rate``. Same audio conventions as
        ``FlowHighSR.generate``: 2-D input takes row 0, int16 input is PCM
        scale and rides the int16 input wire (bit-identical to float), float
        input with |max| > 1 is divided by 32768."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio[0]
        if audio.ndim != 1:
            raise ValueError(f"audio must be [T] or [1, T], got {audio.shape}")
        if len(audio) == 0:
            raise ValueError("audio is empty")
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingPipeline is closed")
            req_id = self._n_submitted
            self._n_submitted += 1
            self._pipe.put((fut, audio, int(sr), seed, req_id))
        return fut

    def generate_many(self, audios: Sequence[np.ndarray], srs,
                      seeds=None) -> list:
        """Submit all, gather in order. ``srs`` may be one int or a per-clip
        sequence; ``seeds`` likewise (None = the per-request default)."""
        if isinstance(srs, int):
            srs = [srs] * len(audios)
        if seeds is None or isinstance(seeds, int):
            seeds = [seeds] * len(audios)
        futs = [self.submit(a, r, s) for a, r, s in zip(audios, srs, seeds)]
        return [f.result() for f in futs]

    def warmup(self, sr: int, seconds: float, dtype=np.float32) -> None:
        """Run one silent request of this (rate, length, input dtype) shape
        before serving traffic: the first run builds the kernels and sets up
        cuFFT plans and cuBLAS handles."""
        n = int(sr * seconds)
        self.submit(np.zeros(max(n, 1), dtype), sr, seed=0).result()

    # -- pipeline stages (each runs on its own StagePipeline thread) --------

    def _stream(self, stream):
        return torch.cuda.stream(stream) if self._cuda \
            else contextlib.nullcontext()

    def _upload(self, item):
        """Pad into a (pinned) host buffer and copy it to the device on the
        upload stream."""
        fut, audio, sr, seed, req_id = item
        m = self.model
        try:
            audio = prepare_clip(audio)
            n = len(audio)
            n_pad = padded_length(n, sr, self.target_sampling_rate)
            host = torch.zeros((1, n_pad), dtype=torch.int16
                               if audio.dtype == np.int16 else torch.float32,
                               pin_memory=self._cuda)
            host[0, :n] = torch.from_numpy(audio)
            seed = request_seed(self.seed, req_id) if seed is None else seed
            generator = m.generator(seed)
            uploaded = None
            with self._stream(self._upload_stream if self._cuda else None):
                batch = host.to(m.device, non_blocking=True)
                lens = torch.tensor([n], device=m.device)
                if self._cuda:
                    uploaded = torch.cuda.Event()
                    uploaded.record()
        except Exception as e:
            fut.set_exception(e)
            return None
        n48 = valid_samples_48k(n, sr, self.target_sampling_rate)
        return (fut, host, batch, lens, uploaded, generator, sr, n48)

    def _dispatch(self, item):
        """Queue the clip's whole pipeline on the compute stream behind its
        upload; never waits for the device."""
        fut, host, batch, lens, uploaded, generator, sr, n48 = item
        m = self.model
        try:
            with torch.inference_mode(), self._stream(
                    self._compute_stream if self._cuda else None):
                if self._cuda:
                    self._compute_stream.wait_event(uploaded)
                    # allocated on the upload stream, used on this one
                    batch.record_stream(self._compute_stream)
                    lens.record_stream(self._compute_stream)
                x = batch.to(torch.float32)
                if batch.dtype == torch.int16:
                    x = x / 32768.0
                out, _, stats = m._generate_impl(x, lens, generator, sr,
                                                 self.target_sampling_rate,
                                                 self.timestep)
                if self.wire == "int16":
                    out = _wire_int16(out)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record()
        except Exception as e:
            fut.set_exception(e)
            return None
        # the pinned input buffer stays referenced until the copy has run
        return (fut, out, stats, done, n48, host)

    def _fetch(self, item):
        """Wait for the clip, copy it to the host, trim, resolve the
        Future. Owns every blocking device-to-host transfer."""
        fut, out, stats, done, n48, _host = item
        try:
            if done is not None:
                done.synchronize()
            _warn_if_unconverged(stats)
            out_np = out[:, :n48].cpu().numpy()
            if out_np.dtype == np.int16:
                out_np = out_np.astype(np.float32) / 32767.0
            fut.set_result(out_np)
        except Exception as e:  # keep draining; this request only
            fut.set_exception(e)
        return None

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Drain every submitted request, then stop the worker threads.
        Idempotent; ``submit`` after close raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pipe.close()

    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, *exc):
        self.close()
