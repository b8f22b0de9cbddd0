"""Serving cells: clips through ``flowhigh_tpu_torch.ServingPipeline``.

Set-up builds ``FlowHighSR`` from the configuration file, loads the seeded
weights through the program's reference-layout loaders, opens the pipeline,
makes the mix's pool of clips and sends one clip of every 1 s bucket the
pool holds through it. The window then offers load by the mix's driver
(``drivers/serve_closed.py``: a fixed number in flight;
``drivers/serve_open.py``: Poisson arrivals at a fixed rate) and records,
for every request, its input seconds, when it was due, when it was sent and
when its result reached the host.

``correct``: the results of a sample of the window's requests, drawn from
the seed (with the pool's longest clip in it), against the plain reference
(``benchmark/reference/pipeline.py``) run after the window, once the
program is freed: the worst relative L2 distance of a result from the
reference's. The splice's cutoff bin is a threshold on a cumulative sum;
where a relative change of 1e-4 of the threshold moves it, the reference
takes each bin it reaches and the nearest counts.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import Future

import numpy as np
import torch

from . import signals, weights
from .phases import Phases

SPLICE_MARGIN = 1e-4
# a traced run profiles the device for TRACE_SECONDS from TRACE_FROM of the
# window's length on, where the loop is steady
TRACE_FROM, TRACE_SECONDS = 0.3, 3.0


def vocoder_config(voc: dict):
    """The configuration file's ``vocoder`` group as the program's
    ``VocoderConfig``."""
    from flowhigh_tpu_torch.config import VocoderConfig
    voc = dict(voc)
    for k in ("upsample_rates", "upsample_kernel_sizes",
              "resblock_kernel_sizes"):
        voc[k] = tuple(voc[k])
    voc["resblock_dilation_sizes"] = tuple(
        tuple(d) for d in voc["resblock_dilation_sizes"])
    return VocoderConfig(**voc)


def flowhigh_config(cfg: dict):
    """The configuration file as the program's ``FlowHighConfig``."""
    from flowhigh_tpu_torch.config import (CFMConfig, FlowHighConfig,
                                           MelConfig, ModelConfig)
    model = {k: v for k, v in cfg["model"].items()
             if k in ModelConfig.__dataclass_fields__}
    cfm = {k: v for k, v in cfg["cfm"].items()
           if k in CFMConfig.__dataclass_fields__}
    return FlowHighConfig(mel=MelConfig(**cfg["mel"]),
                          vocoder=vocoder_config(cfg["vocoder"]),
                          model=ModelConfig(**model), cfm=CFMConfig(**cfm))


class Request:
    __slots__ = ("index", "clip", "seconds", "due", "sent", "done", "error",
                 "out")

    def __init__(self, index, clip, seconds, due):
        self.index, self.clip, self.seconds, self.due = index, clip, seconds, due
        self.sent = self.done = None
        self.error = None
        self.out = None


class Serving(Phases):
    """The state a serving cell's run shares across set-up, window and
    check. ``run_window(seconds, profiles)`` is the driver's."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.traffic
        self.in_sr = int(self.mix["in_sr"])
        self.requests: list = []

    # -- set-up -----------------------------------------------------------------

    def setup(self) -> None:
        from flowhigh_tpu_torch import FlowHighSR, ServingPipeline
        from flowhigh_tpu_torch.compat.torch_ckpt import (
            vector_field_state_from_reference, vocoder_state_from_reference)
        cfg, mix, dev = self.cfg, self.mix, self.device
        serve = cfg["serve"]
        self.mark("start")
        self.sr = FlowHighSR(
            flowhigh_config(cfg), cfm_method=cfg["cfm"]["cfm_method"],
            sigma=cfg["cfm"]["sigma"], ode_method=cfg["cfm"]["ode_method"],
            fuse_act_conv=serve["fuse_act_conv"],
            vocoder_conv_dtype=(None if serve["vocoder_conv_dtype"] == "float32"
                                else serve["vocoder_conv_dtype"]),
            device=dev)
        fw = {k: v.cpu() for k, v in
              weights.field_weights(cfg, self.seed, dev).items()}
        vw = {k: v.cpu() for k, v in
              weights.vocoder_weights(cfg, self.seed, dev).items()}
        self.sr.net.load_state_dict(vector_field_state_from_reference(
            fw, self.sr.net.state_dict()))
        self.sr.vocoder.load_state_dict(vocoder_state_from_reference(
            vw, self.sr.vocoder.state_dict()))
        del fw, vw
        self.mark("FlowHighSR and the seeded weights")
        rng = np.random.default_rng(weights.sub_seed(self.seed, 5))
        self.sizes = signals.lengths(mix["pool"], *mix["seconds"], self.in_sr,
                                     rng)
        self.pool = signals.speech_pool(self.sizes, self.in_sr, mix["signal"],
                                        weights.sub_seed(self.seed, 6), dev)
        self.longest = int(np.argmax(self.sizes))
        self.mark("the pool of clips")
        self.srv = ServingPipeline(self.sr, max_in_flight=mix["in_flight"],
                                   wire=mix["wire"],
                                   timestep=cfg["cfm"]["timestep"],
                                   seed=weights.sub_seed(self.seed, 7))
        # one clip of each 1 s bucket, twice: every shape the window sends
        first = {}
        for i, n in enumerate(self.sizes):
            first.setdefault(math.ceil(n / self.in_sr), i)
        self.buckets = sorted(first.values())
        for _ in range(2):
            for f in [self.srv.submit(self.pool[i], self.in_sr)
                      for i in self.buckets]:
                f.result()
        self.mark("the pipeline and its warm-up (1 s buckets, twice)")
        self.rng = np.random.default_rng(weights.sub_seed(self.seed, 8))
        # requests whose results are kept for the check: the seed's share of
        # them, and every one of the longest clip
        self.keep_every = int(mix["keep_every"])
        self.keep_phase = int(self.rng.integers(self.keep_every))

    # -- the window ---------------------------------------------------------------

    def request(self, index: int, due: float, clip=None) -> Request:
        """Request ``index`` takes ``clip`` of the pool, or the pool's clips
        in turn (the pool's order is the seed's)."""
        clip = index % len(self.sizes) if clip is None else clip
        r = Request(index, clip, self.sizes[clip] / self.in_sr, due)
        self.requests.append(r)
        return r

    def send(self, r: Request, on_done=None) -> Future:
        keep = (r.index % self.keep_every == self.keep_phase
                or r.clip == self.longest)
        r.sent = time.perf_counter()
        fut = self.srv.submit(self.pool[r.clip], self.in_sr)

        def done(f: Future):
            r.done = time.perf_counter()
            exc = f.exception()
            if exc is not None:
                r.error = repr(exc)
            elif keep:
                r.out = f.result()
            if on_done is not None:
                on_done(r)
        fut.add_done_callback(done)
        return fut

    def drain(self, timeout: float = 60.0) -> None:
        """Wait for every request sent, up to ``timeout`` seconds."""
        end = time.perf_counter() + timeout
        while any(r.done is None for r in self.requests if r.sent):
            if time.perf_counter() > end:
                return
            time.sleep(0.01)

    def close(self) -> None:
        if getattr(self, "srv", None) is not None:
            self.srv.close()
            self.srv = None

    def stack_pass(self, path) -> None:
        """The attribution pass of a traced run, after the window: one clip
        of each 1 s bucket (every shape the window sent, so every kernel it
        ran), all sent at once, under the profiler with Python stacks. It
        maps kernels to layers and counts launches a clip; the layers' times
        are read from the window's own profile."""
        from .trace import profiled
        with profiled(path, with_stack=True):
            for f in [self.srv.submit(self.pool[i], self.in_sr)
                      for i in self.buckets]:
                f.result()
        self.stack_clips = len(self.buckets)

    def window_done(self) -> list:
        """The requests whose results reached the host in the window."""
        return [r for r in self.requests if r.error is None
                and r.done is not None and r.done <= self.t_end]

    def audio_rate(self) -> float:
        """Input seconds whose results reached the host in the window, over
        the window's seconds."""
        return (sum(r.seconds for r in self.window_done())
                / (self.t_end - self.t_start))

    def frames(self, r: Request) -> int:
        """The valid 48 kHz mel frames of request ``r`` (no bucket
        padding)."""
        mel = self.cfg["mel"]
        return math.ceil(r.seconds * mel["sampling_rate"] / mel["hop_length"])

    def model_flops(self) -> float:
        """Dots of the field and the vocoder over the valid frames of every
        clip whose result reached the host in the window."""
        from benchmark.work import field, vocoder
        return sum(field.forward(self.cfg["model"], self.frames(r))["dots"]
                   + vocoder.forward(self.cfg["vocoder"], self.frames(r))["dots"]
                   for r in self.window_done())

    # -- after the window ---------------------------------------------------------

    def free(self) -> None:
        self.close()
        self.sr = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The window's requests whose results the check compares, once
        every result has come: ``check_clips`` drawn from the seed among
        those kept, and the first of the pool's longest clip."""
        done = [r for r in self.requests if r.out is not None]
        longest = [r for r in done if r.clip == self.longest][:1]
        rest = [r for r in done if r not in longest]
        n = min(len(rest), int(self.mix["check_clips"]))
        pick = self.rng.choice(len(rest), size=n, replace=False) if n else []
        return longest + [rest[i] for i in sorted(pick)]

    def reference_outputs(self, reqs: list, control=None) -> list:
        """The reference's candidate results for ``reqs``; ``control`` a
        context (``reference.precision.tf32``) for the control's run."""
        import contextlib

        from benchmark.reference import field as rfield
        from benchmark.reference import pipeline, precision, vocoder
        cfg, dev = self.cfg, self.device
        net = rfield.VectorField(cfg["model"]).to(dev)
        rfield.load_reference_state(
            net, weights.field_weights(cfg, self.seed, dev))
        voc = vocoder.fold(weights.vocoder_weights(cfg, self.seed, dev))
        outs = []
        with (control or precision.full_f32)() if dev.type == "cuda" \
                else contextlib.nullcontext():
            for r in reqs:
                outs.append(pipeline.restore(self.pool[r.clip], self.in_sr,
                                             net, voc, cfg, SPLICE_MARGIN))
        return outs

    def counts(self) -> tuple[int, int]:
        """(requests sent in the window, those that failed or never
        returned)."""
        failed = sum(1 for r in self.requests
                     if r.error is not None or r.done is None)
        return len(self.requests), failed

    def check(self) -> tuple[bool, dict]:
        """(correct, {number: {value, limit}})."""
        reqs = self.sample()
        refs = self.reference_outputs(reqs)
        worst = max((gap(r.out[0], cands) for r, cands in zip(reqs, refs)),
                    default=math.inf)
        limit = float(self.cfg["limits"]["serve"]["wave_rel_l2"])
        checks = {"wave_rel_l2": {"value": worst, "limit": limit},
                  "clips_compared": {"value": len(reqs), "limit": 1}}
        return bool(reqs) and worst <= limit, checks


def gap(out: np.ndarray, candidates: list) -> float:
    """The relative L2 distance of ``out`` from the nearest candidate."""
    best = math.inf
    for ref in candidates:
        if ref.shape != out.shape:
            continue
        d = np.linalg.norm(out.astype(np.float64) - ref)
        best = min(best, float(d / max(np.linalg.norm(ref), 1e-30)))
    return best


class Window:
    """Times one window on the host clock and, in a traced run, profiles the
    device over a steady part of it (``TRACE_SECONDS`` from ``TRACE_FROM``
    of its length on)."""

    def __init__(self, seconds: float, profiles=None, start=None):
        self.seconds = seconds
        self.profile = (profiles or {}).get("plain")
        if self.profile is not None:  # exported after the window
            self.profile.defer = True
        self.start = time.perf_counter() if start is None else start
        self.end = self.start + seconds
        self.p0 = self.start + TRACE_FROM * seconds
        self.p1 = min(self.p0 + TRACE_SECONDS, self.start + 0.9 * seconds)
        self.state = 0  # 0 before the profile, 1 in it, 2 after

    def tick(self) -> None:
        """Start or stop the profile when its time has come."""
        if self.profile is None:
            return
        now = time.perf_counter()
        if self.state == 0 and now >= self.p0:
            self.profile.start()
            self.state = 1
        elif self.state == 1 and now >= self.p1:
            self.profile.stop()
            self.state = 2

    def finish(self) -> None:
        if self.profile is not None and self.state == 1:
            self.profile.stop()
            self.state = 2


def wait_until(t: float, window: Window) -> None:
    while True:
        window.tick()
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.005))

