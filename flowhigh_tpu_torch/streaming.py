"""Long-form streaming inference: independent chunks + equal-power
crossfade; counterpart of ``flowhigh_tpu/streaming.py:StreamingSR``.

Long audio is cut into fixed-size chunks (10 s, 1 s overlap by default);
each chunk runs the whole clip pipeline (``FlowHighSR.dispatch_generate``,
the spectral splice included), and the chunks are stitched with an
equal-power crossfade over each overlap. Three threads
(``pipeline.StagePipeline``) overlap one batch's upload, another's compute
and a third's download; at most ``pipeline_depth`` batches are queued on
the card but not yet fetched.

``generate_sharded`` runs one clip's chunks across the ranks of a mesh
(``FlowHighSR.make_sharded_generate``) and stitches them the same way.

The other long-form mode is ``FlowHighSR.generate_longform``: one pass of
the vector field over the whole clip (kernel F's O(N) attention), no seams.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .pipeline import StagePipeline
from .serving import request_seed
from .sr import FlowHighSR, _warn_if_unconverged


class StreamingSR:
    def __init__(self, model: FlowHighSR, chunk_seconds: float = 10.0,
                 overlap_seconds: float = 1.0, batch_size: int = 1,
                 pipeline_depth: int = 8, wire: str = "float32"):
        """``batch_size`` chunks run as one batch; ``pipeline_depth`` bounds
        the batches dispatched to the card but not yet fetched (device
        memory backpressure; 0 would make that queue unbounded).

        ``wire='int16'`` downloads each chunk quantised to int16 on the
        device (``sr._wire_int16``), half the device-to-host bytes; the
        stitcher converts back to float before the crossfade. Each chunk's
        splice ends in a x0.99 peak-norm, so the error stays pure
        quantisation (<= 0.5 / 32767 per sample) through the convex
        crossfade."""
        if not overlap_seconds < chunk_seconds / 2:
            raise ValueError(f"overlap_seconds ({overlap_seconds}) must be "
                             f"below half of chunk_seconds ({chunk_seconds})")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth} (0 would "
                "make the dispatch queue unbounded)")
        if wire not in ("float32", "int16"):
            raise ValueError(f"wire must be 'float32' or 'int16', got {wire!r}")
        self.model = model
        self.chunk_seconds = chunk_seconds
        self.overlap_seconds = overlap_seconds
        self.batch_size = batch_size
        self.pipeline_depth = pipeline_depth
        self.wire = wire
        self._sharded_fns: dict = {}  # generate_sharded's, by mesh layout

    def generate(self, audio: np.ndarray, sr: int,
                 target_sampling_rate: int = 48000, timestep: int = 1,
                 seed: int = 0) -> np.ndarray:
        """[T] or [1, T] waveform at ``sr`` -> [1, T * target / sr] at 48 kHz.

        int16 input is PCM scale and rides the int16 input wire chunk by
        chunk (bit-identical to passing float); float input with |max| > 1
        is divided by 32768. A clip no longer than one chunk is
        ``model.generate``. Batch ``i`` of chunks draws its prior from a
        generator seeded with ``serving.request_seed(seed, i)``; with the
        default sigma = 0 the prior is the conditioning itself, so the
        result does not depend on the seed."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio[0]
        int16_in = audio.dtype == np.int16
        if not int16_in and np.abs(audio).max() > 1:
            audio = audio / 32768.0

        chunk_in = int(self.chunk_seconds * sr)
        if len(audio) <= chunk_in:
            return self.model.generate(audio, sr, target_sampling_rate,
                                       timestep, seed)
        seg_dtype = np.int16 if int16_in else np.float32
        segs, stitch = self._chunks(audio, sr, target_sampling_rate, seg_dtype)
        n_chunks = len(segs)

        model, bs = self.model, self.batch_size
        cuda = model.device.type == "cuda"
        if cuda:
            compute = torch.cuda.Stream(model.device)
            compute.wait_stream(torch.cuda.current_stream(model.device))
        lens = np.full((bs,), chunk_in, np.int64)
        ys: list = []

        def upload(item):
            bi, b0 = item
            batch = segs[b0:b0 + bs]
            nb = len(batch)
            # pad rows so that every batch has one shape
            batch = batch + [np.zeros(chunk_in, seg_dtype)] * (bs - nb)
            host = torch.from_numpy(np.stack(batch))
            return bi, host.pin_memory() if cuda else host, nb

        def dispatch(item):
            bi, host, nb = item
            with (torch.cuda.stream(compute) if cuda
                  else contextlib.nullcontext()):
                out, _, stats = model.dispatch_generate(
                    host, lens, sr, target_sampling_rate, timestep,
                    generator=model.generator(request_seed(seed, bi)),
                    wire=self.wire)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
            # the pinned buffer stays referenced until its copy has run
            return out, stats, nb, done, host

        def fetch(item):
            out, stats, nb, done, _host = item
            if done is not None:
                done.synchronize()
            _warn_if_unconverged(stats)
            out_np = out.cpu().numpy()
            if out_np.dtype == np.int16:
                out_np = out_np.astype(np.float32) / 32767.0
            ys.extend(out_np[i] for i in range(nb))

        pipe = StagePipeline([upload, dispatch, fetch],
                             depths=[4, self.pipeline_depth])
        for bi, b0 in enumerate(range(0, n_chunks, bs)):
            pipe.put((bi, b0))
        pipe.close()
        if pipe.stage_errors:
            raise pipe.stage_errors[0]
        return stitch(ys)

    def _chunks(self, audio: np.ndarray, sr: int, target_sr: int, dtype):
        """(the clip's chunks of ``chunk_seconds`` every ``chunk_seconds -
        overlap_seconds``, the last zero-padded, as ``dtype``; the function
        that stitches their outputs into the whole clip's)."""
        n = len(audio)
        chunk_in = int(self.chunk_seconds * sr)
        overlap_in = int(self.overlap_seconds * sr)
        hop_in = chunk_in - overlap_in
        g = math.gcd(target_sr, sr)
        ratio, den = target_sr // g, sr // g

        def to_out(x: int) -> int:
            return x * ratio // den

        n_chunks = 1 + math.ceil((n - chunk_in) / hop_in)
        segs = []
        for c in range(n_chunks):
            seg = audio[c * hop_in: c * hop_in + chunk_in]
            if len(seg) < chunk_in:
                seg = np.pad(seg, (0, chunk_in - len(seg)))
            segs.append(seg.astype(dtype))
        return segs, lambda ys: self._stitch(ys, n_chunks, hop_in, chunk_in,
                                             overlap_in, to_out, to_out(n))

    @staticmethod
    def _stitch(ys, n_chunks: int, hop_in: int, chunk_in: int,
                overlap_in: int, to_out, total_out: int) -> np.ndarray:
        """Overlap-add the per-chunk 48 kHz waveforms with an equal-power
        (sin^2) crossfade over each overlap; samples where only one chunk
        contributes (weight 1) pass through unchanged."""
        out = np.zeros(total_out, np.float32)
        weight = np.zeros(total_out, np.float32)
        overlap_out = to_out(overlap_in)
        ramp = np.sin(0.5 * np.pi * np.linspace(0, 1, overlap_out)) ** 2
        for c in range(n_chunks):
            y = ys[c][: to_out(chunk_in)]
            w = np.ones(len(y), np.float32)
            if c > 0:
                w[:overlap_out] = ramp
            if c < n_chunks - 1:
                w[len(y) - overlap_out:] = ramp[::-1]
            o0 = to_out(c * hop_in)
            o1 = min(o0 + len(y), total_out)
            out[o0:o1] += (y * w)[: o1 - o0]
            weight[o0:o1] += w[: o1 - o0]
        return (out / np.maximum(weight, 1e-8))[None, :]

    def generate_sharded(self, audio: np.ndarray, sr: int, mesh,
                         target_sampling_rate: int = 48000,
                         timestep: int = 1, seed: int = 0) -> np.ndarray:
        """Chunk-parallel long-form over a mesh of ranks: one clip's chunks
        sharded across the ``data`` axis through
        ``FlowHighSR.make_sharded_generate`` (every rank calls it with the
        same clip and gets the whole result), stitched on the host with
        ``generate``'s equal-power crossfade. The chunk geometry is
        ``generate``'s; the chunk count is padded up to a multiple of the
        ``data`` size with zero rows (dropped after). Calls with the same
        mesh layout, rates and steps reuse one sharded function. int16
        input is converted on the host (PCM scale); a clip no longer than
        one chunk is ``model.generate``."""
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio[0]
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        elif np.abs(audio).max() > 1:
            audio = audio / 32768.0

        chunk_in = int(self.chunk_seconds * sr)
        if len(audio) <= chunk_in:
            return self.model.generate(audio, sr, target_sampling_rate,
                                       timestep, seed)
        segs, stitch = self._chunks(audio, sr, target_sampling_rate,
                                    np.float32)
        n_chunks = len(segs)
        n_data = mesh.shape["data"]
        n_rows = math.ceil(n_chunks / n_data) * n_data
        segs += [np.zeros(chunk_in, np.float32)] * (n_rows - n_chunks)

        # keyed by the mesh's structure, not id(mesh): a collected mesh's
        # address can be reused by another
        cache_key = (mesh.key, sr, target_sampling_rate, timestep)
        fn = self._sharded_fns.get(cache_key)
        if fn is None:
            fn = self.model.make_sharded_generate(
                mesh, in_sr=sr, target_sampling_rate=target_sampling_rate,
                timestep=timestep)
            self._sharded_fns[cache_key] = fn
        out, _ = fn(np.stack(segs), np.full(n_rows, chunk_in, np.int64),
                    seed=seed)
        return stitch(list(out.cpu().numpy()[:n_chunks]))
