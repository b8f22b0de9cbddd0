"""BigVGAN's GAN trainer — counterpart of
``flowhigh_tpu/train/vocoder_trainer.py`` on one device (the JAX trainer's
mesh is ROADMAP.md queue 1 item 13).

A step, as the JAX trainer's: the mel of each segment (no gradient), the
generator's waveform computed once with its graph, a discriminator update
(MPD + MRD, LS-GAN) on that waveform detached, then a generator update
whose loss (LS-GAN + 2 x feature matching + ``mel_loss_weight`` x L1
log-mel) reads the discriminators after their update. Two Adams, lr 2e-4,
betas (0.8, 0.99), eps 1e-8, as ``optax.adam``.

The generator is the JAX trainer's plain one: ``BigVGAN(voc_cfg,
fuse_act_conv=False)``, float32 dots and maps, which runs kernels A, B and
C on the card, each with a gradient (the VJP of its plain version,
``ops/``). Kernels B and C read their weights through a layout cached by
the tensor's version counter (``ops/quant.py:_cached``), so the optimizers
are foreach Adams, whose in-place updates bump it; the fused Adam does not.

Checkpoints: ``save`` writes the whole state (``vocoder_state_<step>.pt``:
the three modules, both optimizers, the step), which ``restore_state``
and ``fit(auto_resume=True)`` resume bit for bit, and the reference's
generator package ``g_<step:08d>`` ``{"generator": ...}`` in the
weight-normed layout (``compat.vocoder_state_to_reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from ..compat.jax_params import (mpd_state_from_jax, mrd_state_from_jax,
                                 seeded_init_, vocoder_state_from_jax)
from ..compat.torch_ckpt import vocoder_state_to_reference
from ..config import MelConfig, VocoderConfig
from ..models import BigVGAN
from ..models.discriminators import (MultiPeriodDiscriminator,
                                     MultiResolutionDiscriminator,
                                     discriminator_loss, feature_loss,
                                     generator_loss, init_discriminator_)
from ..models.melvoco import encode
from ..utils import cudnn_f32, resolve_device

STATE_PREFIX = "vocoder_state_"


@dataclasses.dataclass
class VocoderTrainState:
    """``step`` counts GAN steps (one a ``train_step``)."""
    step: int
    generator: BigVGAN
    mpd: MultiPeriodDiscriminator
    mrd: MultiResolutionDiscriminator
    gen_optimizer: torch.optim.Adam
    disc_optimizer: torch.optim.Adam


@contextlib.contextmanager
def _frozen(modules):
    """No parameter of ``modules`` requires a gradient inside (the
    generator's update does not differentiate the discriminators)."""
    params = [p for m in modules for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class VocoderTrainer:
    def __init__(self, voc_cfg: VocoderConfig = VocoderConfig(),
                 mel_cfg: MelConfig = MelConfig(), mesh=None,
                 lr: float = 2e-4, adam_b1: float = 0.8,
                 adam_b2: float = 0.99, mel_loss_weight: float = 45.0,
                 segment_frames: int = 32,
                 results_folder: str = "./vocoder_results",
                 periods=None, resolutions=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "VocoderTrainer runs on one device: a mesh (data-parallel "
                "training over several cards) is ROADMAP.md queue 1 item 13")
        self.voc_cfg, self.mel_cfg = voc_cfg, mel_cfg
        self.lr, self.betas = lr, (adam_b1, adam_b2)
        self.mel_loss_weight = mel_loss_weight
        self.segment_frames = segment_frames
        self.results_folder = Path(results_folder)
        self.periods = tuple(periods) if periods else None
        self.resolutions = (tuple(tuple(r) for r in resolutions)
                            if resolutions else None)
        self.device = resolve_device(device)

    @property
    def segment_samples(self) -> int:
        return self.segment_frames * self.mel_cfg.hop_length

    # -- state ------------------------------------------------------------------

    def _adam(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr, betas=self.betas,
                                eps=1e-8, foreach=True)

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[dict] = None) -> VocoderTrainState:
        """A fresh state on the device: the generator from
        ``seeded_init_(seed)`` and the discriminators from
        ``init_discriminator_`` (seeds ``seed + 1``, ``seed + 2``), or all
        three from ``params`` = {"gen", "mpd", "mrd"}, the JAX package's
        param trees (numpy leaves); both optimizers fresh."""
        seed = 0 if seed is None else seed
        gen = BigVGAN(self.voc_cfg, fuse_act_conv=False)
        mpd = (MultiPeriodDiscriminator(self.periods) if self.periods
               else MultiPeriodDiscriminator())
        mrd = (MultiResolutionDiscriminator(self.resolutions)
               if self.resolutions else MultiResolutionDiscriminator())
        if params is None:
            seeded_init_(gen, seed)
            init_discriminator_(mpd, seed + 1)
            init_discriminator_(mrd, seed + 2)
        else:
            gen.load_state_dict(vocoder_state_from_jax(params["gen"],
                                                       self.voc_cfg))
            mpd.load_state_dict(mpd_state_from_jax(params["mpd"], mpd.periods))
            mrd.load_state_dict(mrd_state_from_jax(params["mrd"],
                                                   mrd.resolutions))
        for m in (gen, mpd, mrd):
            m.to(self.device).train()
        return VocoderTrainState(
            0, gen, mpd, mrd, self._adam(gen.parameters()),
            self._adam(list(mpd.parameters()) + list(mrd.parameters())))

    # -- the GAN step -------------------------------------------------------------

    def segments(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(wav [B, segment_samples] on the device, its log-mel [B, frames,
        n_mels], no gradient) of ``batch`` ({"wave": [B, >=
        segment_samples]} at 48 kHz); the generator reads the first
        ``segment_frames`` frames of the mel."""
        wav = torch.as_tensor(batch["wave"], dtype=torch.float32)[
            :, :self.segment_samples].to(self.device)
        with torch.no_grad():
            return wav, encode(wav, self.mel_cfg)

    @staticmethod
    def disc_loss(mpd, mrd, wav: torch.Tensor,
                  fake: torch.Tensor) -> torch.Tensor:
        """The discriminators' LS-GAN loss, MPD's plus MRD's."""
        return (discriminator_loss(*mpd(wav, fake)[:2])[0]
                + discriminator_loss(*mrd(wav, fake)[:2])[0])

    def gen_loss(self, mpd, mrd, wav: torch.Tensor, fake: torch.Tensor,
                 mel_real: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(the generator's loss, its mel term): LS-GAN and feature
        matching against both discriminators, plus ``mel_loss_weight`` x
        the L1 distance of the log-mels."""
        _, o_g, f_r, f_g = mpd(wav, fake)
        _, o_g2, f_r2, f_g2 = mrd(wav, fake)
        l_mel = torch.mean(torch.abs(encode(fake, self.mel_cfg)
                                     - mel_real)) * self.mel_loss_weight
        return (generator_loss(o_g)[0] + generator_loss(o_g2)[0]
                + feature_loss(f_r, f_g) + feature_loss(f_r2, f_g2)
                + l_mel), l_mel

    def train_step(self, state: VocoderTrainState, batch: dict):
        """One GAN step on ``batch`` (see ``segments``). Returns (state,
        {"disc_loss", "gen_loss", "mel_l1"}) with device scalars; each
        parameter's ``grad`` keeps this step's gradient."""
        wav, mel_real = self.segments(batch)
        gen, mpd, mrd = state.generator, state.mpd, state.mrd
        fake = gen(mel_real[:, :self.segment_frames].contiguous())[
            :, :wav.shape[1]]
        d_loss = self.disc_loss(mpd, mrd, wav, fake.detach())
        state.disc_optimizer.zero_grad(set_to_none=True)
        with cudnn_f32():  # the library convs' backward in f32, not TF32
            d_loss.backward()
        state.disc_optimizer.step()
        with _frozen((mpd, mrd)):  # the discriminators after their update
            g_loss, l_mel = self.gen_loss(mpd, mrd, wav, fake, mel_real)
            state.gen_optimizer.zero_grad(set_to_none=True)
            with cudnn_f32():
                g_loss.backward()
        state.gen_optimizer.step()
        state.step += 1
        return state, {"disc_loss": d_loss.detach(),
                       "gen_loss": g_loss.detach(), "mel_l1": l_mel.detach()}

    # -- checkpointing ----------------------------------------------------------

    def latest_checkpoint(self) -> Optional[Path]:
        """The newest ``vocoder_state_<step>.pt`` in the results folder."""
        cands = sorted(self.results_folder.glob(STATE_PREFIX + "*.pt"),
                       key=lambda p: int(p.stem[len(STATE_PREFIX):]))
        return cands[-1] if cands else None

    def save(self, state: VocoderTrainState,
             folder: Optional[Path] = None) -> Path:
        """The whole GAN state as ``vocoder_state_<step>.pt`` and the
        reference's generator package ``g_<step:08d>``; returns the
        first's path."""
        folder = Path(folder or self.results_folder)
        folder.mkdir(parents=True, exist_ok=True)
        path = folder / f"{STATE_PREFIX}{state.step}.pt"
        torch.save({"step": state.step,
                    "generator": state.generator.state_dict(),
                    "mpd": state.mpd.state_dict(),
                    "mrd": state.mrd.state_dict(),
                    "gen_optimizer": state.gen_optimizer.state_dict(),
                    "disc_optimizer": state.disc_optimizer.state_dict()},
                   path)
        torch.save({"generator": vocoder_state_to_reference(
            state.generator.state_dict(), self.voc_cfg)},
            folder / f"g_{state.step:08d}")
        return path

    def restore_state(self, path, template: VocoderTrainState
                      ) -> VocoderTrainState:
        """``template`` (a fresh ``init_state``) with the whole state of
        ``save``'s file at ``path`` loaded into it."""
        path = Path(path)
        if path.is_dir():
            raise ValueError(
                f"{path} is a directory: an orbax checkpoint of the JAX "
                "package, which this package cannot read; load the "
                "g_<step> generator package that the JAX trainer's save "
                "writes beside it")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        template.generator.load_state_dict(sd["generator"])
        template.mpd.load_state_dict(sd["mpd"])
        template.mrd.load_state_dict(sd["mrd"])
        template.gen_optimizer.load_state_dict(sd["gen_optimizer"])
        template.disc_optimizer.load_state_dict(sd["disc_optimizer"])
        template.step = int(sd["step"])
        return template

    # -- loop -------------------------------------------------------------------

    def fit(self, data_iter: Iterator[dict],
            state: Optional[VocoderTrainState] = None, num_steps: int = 1000,
            log_every: int = 10, log_fn=print, save_every: int = 0,
            auto_resume: bool = False) -> VocoderTrainState:
        """Train to ``num_steps`` GAN steps, logging the JAX trainer's line
        every ``log_every``; ``save_every > 0`` saves into the results
        folder; ``auto_resume`` restarts from its newest state file."""
        if state is None:
            state = self.init_state(0)
            if auto_resume:
                ckpt = self.latest_checkpoint()
                if ckpt is not None:
                    log_fn(f"[vocoder] auto-resuming from {ckpt}")
                    state = self.restore_state(ckpt, state)
        t0 = time.time()
        start = state.step
        for i in range(start, num_steps):
            state, m = self.train_step(state, next(data_iter))
            if (i + 1) % log_every == 0:
                log_fn(f"[vocoder] step {i+1} "
                       f"disc={float(m['disc_loss']):.3f} "
                       f"gen={float(m['gen_loss']):.3f} "
                       f"mel_l1={float(m['mel_l1']):.3f} "
                       f"({(i+1-start)/(time.time()-t0):.2f} it/s)")
            if save_every and (i + 1) % save_every == 0:
                self.save(state)
        return state


__all__ = ["VocoderTrainer", "VocoderTrainState"]
