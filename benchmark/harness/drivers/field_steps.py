"""The vector field's training step, ``flowhigh_tpu_torch.train.Trainer``,
back to back on the mix's batches (the published recipe, fed from the
device: the data layer is bypassed), each step's draws made from the seed
and passed as ``draws=``."""

from __future__ import annotations

import dataclasses
import sys

import torch

from .. import compare, signals, weights
from ..compare import norm as _norm
from ..serving import flowhigh_config
from ..steps import Steps


# the numbers the field's cell compares
numbers = compare.training

class Driver(Steps):
    end_to_end_name = "train_crops_per_s"

    def setup(self) -> None:
        from flowhigh_tpu_torch.compat.torch_ckpt import \
            vector_field_state_from_reference
        from flowhigh_tpu_torch.config import TrainConfig
        from flowhigh_tpu_torch.train import Trainer
        cfg, mix, dev = self.cfg, self.mix, self.device
        self.mark("start")
        train = {k: v for k, v in cfg["train"].items()
                 if k in TrainConfig.__dataclass_fields__}
        fcfg = dataclasses.replace(flowhigh_config(cfg),
                                   train=TrainConfig(**train))
        self.trainer = Trainer(fcfg, device=dev)
        fw = {k: v.cpu() for k, v in
              weights.field_weights(cfg, self.seed, dev).items()}
        expected = {k: torch.empty(s, device="meta") for k, s in
                    weights.field_shapes(cfg["model"]).items()}
        self.state = self.trainer.init_state(
            weights.sub_seed(self.seed, 10),
            params=vector_field_state_from_reference(fw, expected))
        del fw
        self.mark("the trainer and the seeded weights")
        self.units = int(mix["batch"])
        self.pool = [self.batch(i) for i in range(int(mix["pool"]))]
        self.mark("the pool of batches")
        self.first = self.first_steps(int(mix["check_steps"]))
        self.mark("the first steps")

    # -- inputs ---------------------------------------------------------------------

    def batch(self, i: int) -> dict:
        mix = self.mix
        return signals.tones(int(mix["batch"]), mix["seconds"],
                             mix["cutoff_hz"],
                             weights.sub_seed(self.seed, 20, i), self.device)

    def draws(self, k: int) -> dict:
        """Step ``k``'s random numbers (``cfm.TrainingDraws``' fields)."""
        mel = self.cfg["mel"]
        n = int(self.mix["seconds"][1] * mel["sampling_rate"])
        frames = 1 + (n - mel["hop_length"]) // mel["hop_length"]
        b, m = int(self.mix["batch"]), mel["n_mels"]
        gen = torch.Generator(device=self.device).manual_seed(
            weights.sub_seed(self.seed, 30, k))
        kw = dict(generator=gen, device=self.device)
        return {"t": torch.rand(b, **kw), "eps": torch.randn(b, frames, m, **kw),
                "crop_u": torch.rand(b, **kw), "drop_u": torch.rand(b, **kw),
                "fm_height": torch.randint(10, 21, (b,), **kw),
                "fm_start": torch.randint(20, max(m - 20, 21), (b,), **kw)}

    def _step(self, batch: dict, draws: dict):
        from flowhigh_tpu_torch.cfm import TrainingDraws
        return self.trainer.train_step(self.state, batch,
                                       draws=TrainingDraws(**draws))

    # -- set-up's steps and the window's ------------------------------------------------

    def first_steps(self, n: int) -> dict:
        net = self.state.net
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        losses, grad = [], None
        b1 = self.cfg["train"]["adam_b1"]
        for k in range(n):
            self.state, m = self._step(self.pool[k % len(self.pool)],
                                       self.draws(k))
            losses.append(m["loss"])
            if k == 0:  # the gradient as Adam got it, from its state
                st = self.state.optimizer.inner.state
                grad = {name: _norm(st.get(p, {}).get("exp_avg")) / (1 - b1)
                        for name, p in net.named_parameters()}
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in net.named_parameters()}
        return {"losses": [float(v) for v in losses], "grad": grad,
                "change": change}

    def step(self, i: int) -> None:
        k = int(self.mix["check_steps"]) + i
        self._step(self.pool[k % len(self.pool)], self.draws(k))

    def model_flops(self) -> float:
        """The field's dots on the crops, forward and twice for the
        backward, and the mel filterbank's products of both waves."""
        from benchmark.work import field
        mel, b = self.cfg["mel"], int(self.mix["batch"])
        seg = self.cfg["train"]["segment_frames"]
        n = int(self.mix["seconds"][1] * mel["sampling_rate"])
        frames = 1 + (n - mel["hop_length"]) // mel["hop_length"]
        per = (3 * field.forward(self.cfg["model"], seg, b)["dots"]
               + 2 * 2.0 * b * frames * mel["n_mels"] * (mel["n_fft"] // 2 + 1))
        return per * self.done

    # -- after the window ------------------------------------------------------------

    def free(self) -> None:
        self.trainer = self.state = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, n: int, quant=None, rows=None) -> dict:
        """The plain reference's first ``n`` steps from the seed's weights
        on the same batches and draws; ``quant`` the control's products,
        ``rows`` a slice of each batch (a planted fault)."""
        from benchmark.reference import field as rfield
        from benchmark.reference import train as rtrain
        net = rfield.VectorField(self.cfg["model"]).to(self.device)
        rfield.load_reference_state(
            net, weights.field_weights(self.cfg, self.seed, self.device))
        net.quant = quant
        pool = int(self.mix["pool"])
        batches = [self.batch(k % pool) for k in range(n)]
        draws = [self.draws(k) for k in range(n)]
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
            draws = [{k: v[rows] for k, v in d.items()} for d in draws]
        return rtrain.steps(net, batches, draws, self.cfg)

    def check(self) -> tuple[bool, dict]:
        from benchmark.reference import precision
        n = int(self.mix["check_steps"])
        with precision.full_f32():
            ref = self.reference(n)
        found = numbers(self.first, ref)
        for line in compare.details(self.first, ref):
            print("detail " + line, file=sys.stderr, flush=True)
        limits = self.cfg["limits"]["train"]
        checks = {k: {"value": v, "limit": float(limits[k])}
                  for k, v in found.items()}
        return all(c["value"] <= c["limit"] for c in checks.values()), checks
