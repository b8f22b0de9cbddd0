"""BigVGAN's GAN step, ``flowhigh_tpu_torch.train.VocoderTrainer``, back to
back on the mix's batches of segments (the generator unfused, so kernels A,
B and C run with a gradient)."""

from __future__ import annotations

import sys

import torch

from .. import compare, signals, weights
from ..compare import norm as _norm
from ..steps import Steps


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers the GAN cell compares: ``loss_gap`` over the first
    step's losses (its generator loss follows the discriminators' first
    update), ``loss_gap_2`` over the second step's (after the generator's
    first update), the first gradient's and the change's worst leaves. The
    two steps' losses have limits of their own: the first update is about
    lr x sign(g), so elements whose gradient is within rounding of 0 move
    either way, and sound runs part by up to 4e-4 at step 2 where step 1
    agrees to 1e-6 (the third step's losses, by up to 1.1%, are not
    compared)."""
    out = compare.training(prog, ref, 1)
    out["loss_gap_2"] = compare.step_loss_gap(prog, ref, 1)
    return out


class Driver(Steps):
    end_to_end_name = "gan_segments_per_s"

    def setup(self) -> None:
        from flowhigh_tpu_torch.compat.torch_ckpt import \
            vocoder_state_from_reference
        from flowhigh_tpu_torch.config import MelConfig
        from flowhigh_tpu_torch.train import VocoderTrainer
        from ..serving import vocoder_config
        cfg, mix, dev = self.cfg, self.mix, self.device
        self.mark("start")
        g = cfg["gan"]
        if g["fuse_act_conv"]:
            raise ValueError("the GAN trainer's generator is unfused")
        self.trainer = VocoderTrainer(
            vocoder_config(cfg["vocoder"]),
            MelConfig(**cfg["mel"]), lr=g["lr"], adam_b1=g["adam_b1"],
            adam_b2=g["adam_b2"], mel_loss_weight=g["mel_loss_weight"],
            segment_frames=g["segment_frames"], periods=g["periods"],
            resolutions=g["resolutions"], device=dev)
        self.state = self.trainer.init_state(weights.sub_seed(self.seed, 10))
        self.mark("the trainer's own seeded init")
        gen = self.state.generator
        vw = {k: v.cpu() for k, v in
              weights.vocoder_weights(cfg, self.seed, dev).items()}
        gen.load_state_dict(vocoder_state_from_reference(vw, gen.state_dict()))
        dw = weights.discriminator_weights(cfg, self.seed, dev)
        for name in ("mpd", "mrd"):
            getattr(self.state, name).load_state_dict(
                {k[4:]: v for k, v in dw.items() if k.startswith(name + ".")})
        del vw, dw
        self.mark("the seeded weights loaded")
        self.units = self.batch_size
        self.pool = [self.waves(i) for i in range(int(mix["pool"]))]
        self.first = self.first_steps(int(mix["check_steps"]))
        self.mark("the pool and the first steps")

    @property
    def batch_size(self) -> int:
        return int(self.mix["batch"])

    @property
    def frames(self) -> int:
        return self.cfg["gan"]["segment_frames"]

    def waves(self, i: int) -> torch.Tensor:
        """A batch of segments: four tones and noise at 48 kHz, the first
        segment of ``signals.tones``' waves."""
        n = self.frames * self.cfg["mel"]["hop_length"]
        sr = self.cfg["mel"]["sampling_rate"]
        b = signals.tones(self.batch_size, (n / sr, n / sr), (sr / 2, sr / 2),
                          weights.sub_seed(self.seed, 20, i), self.device)
        return b["wave"][:, :n].contiguous()

    def _named(self) -> dict:
        s = self.state
        return {**dict(s.generator.named_parameters()),
                **{f"mpd.{k}": p for k, p in s.mpd.named_parameters()},
                **{f"mrd.{k}": p for k, p in s.mrd.named_parameters()}}

    def first_steps(self, n: int) -> dict:
        named = self._named()
        start = {k: p.detach().clone() for k, p in named.items()}
        losses = {"disc_loss": [], "gen_loss": [], "mel_l1": []}
        grad = None
        b1 = self.cfg["gan"]["adam_b1"]
        for k in range(n):
            self.state, m = self.trainer.train_step(
                self.state, {"wave": self.pool[k % len(self.pool)]})
            for name in losses:
                losses[name].append(m[name])
            if k == 0:
                st = {**self.state.gen_optimizer.state,
                      **self.state.disc_optimizer.state}
                grad = {name: _norm(st.get(p, {}).get("exp_avg")) / (1 - b1)
                        for name, p in named.items()}
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in named.items()}
        return {"losses": {k: [float(v) for v in vs]
                           for k, vs in losses.items()},
                "grad": grad, "change": change}

    def step(self, i: int) -> None:
        k = int(self.mix["check_steps"]) + i
        self.trainer.train_step(self.state,
                                {"wave": self.pool[k % len(self.pool)]})

    def model_flops(self) -> float:
        """The generator's dots forward and twice for its backward; the
        discriminators' on the real and the generated segments in the
        discriminators' update, forward and twice for its backward, and in
        the generator's, forward on both and twice on the generated one for
        the backward to the wave; the mel filterbank's products."""
        from benchmark.work import discriminators, vocoder
        g, mel, b = self.cfg["gan"], self.cfg["mel"], self.batch_size
        gen = vocoder.forward(self.cfg["vocoder"], self.frames, b)["dots"]
        d = discriminators.forward(g["periods"], g["resolutions"],
                                   self.frames * mel["hop_length"], b)["dots"]
        mels = 2.0 * b * self.frames * mel["n_mels"] * (mel["n_fft"] // 2 + 1)
        per = 3 * gen + (3 * 2 * d) + (2 * d + 2 * d) + 3 * mels
        return per * self.done

    def free(self) -> None:
        self.trainer = self.state = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, n: int, rows=None, lr_scale: float = 1.0) -> dict:
        """The plain reference's first ``n`` steps from the seed's weights
        on the same batches; ``rows`` a slice of each batch, ``lr_scale``
        a factor on both rates (planted faults)."""
        from benchmark.reference import gan, vocoder
        cfg, dev = self.cfg, self.device
        cfg = dict(cfg, gan=dict(cfg["gan"], lr=cfg["gan"]["lr"] * lr_scale))
        gen_w = vocoder.fold(weights.vocoder_weights(cfg, self.seed, dev))
        disc_w = weights.discriminator_weights(cfg, self.seed, dev)
        pool = int(self.mix["pool"])
        waves = [self.waves(k % pool) for k in range(n)]
        if rows is not None:
            waves = [w[rows] for w in waves]
        return gan.steps(gen_w, disc_w, waves, cfg)

    def check(self) -> tuple[bool, dict]:
        from benchmark.reference import precision
        with precision.full_f32():
            ref = self.reference(int(self.mix["check_steps"]))
        found = numbers(self.first, ref)
        for line in compare.details(self.first, ref):
            print("detail " + line, file=sys.stderr, flush=True)
        limits = self.cfg["limits"]["gan"]
        checks = {k: {"value": v, "limit": float(limits[k])}
                  for k, v in found.items()}
        return all(c["value"] <= c["limit"] for c in checks.values()), checks
