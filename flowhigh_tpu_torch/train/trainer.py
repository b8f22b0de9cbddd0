"""The CFM trainer of the vector field — counterpart of
``flowhigh_tpu/train/trainer.py``, on one device or over a mesh of ranks.

A step: per-item peak-normalised condition waves, both waves mel-encoded
on the device (no gradient), ``cfm.cfm_training_loss`` on 2 s crops,
backward, and ``train.optimizer.Optimizer`` (clip 0.5, Adam, warmup and
cosine, gradient accumulation). ``TrainConfig.amp_dtype`` takes the place
of the field's ``compute_dtype``: the field computes at the JAX package's
cast points in that dtype (bfloat16 by default) while parameters,
gradients and the loss stay float32. Every parameter trains, ``null_cond``
included (the JAX trainer differentiates every leaf), although the
reference keeps it frozen.

Checkpoints: ``save`` writes the whole state (``trainstate_<micro-step>
.pt``: parameters, optimizer, accumulator, generator), which
``restore_state`` and ``fit(auto_resume=True)`` resume bit for bit, and
the reference's package ``FLowHigh.<updates>.pt`` (``export_torch``).

Under a mesh (``parallel.make_mesh``, ``make_global_mesh``), the step
computes what the JAX trainer's one global program computes:

- ``data``: DDP over the ``data`` group (gradients averaged, the loss
  being each rank's share of the global-batch mean over equal shards).
  ``train_step`` takes the global batch and keeps this rank's rows (those
  of its ``data`` index), or the local rows of ``shard_global_batch``.
  Every rank draws the global batch's ``TrainingDraws`` and dropout masks
  from its generator and keeps its rows (``utils.RowShard``), so the
  generators stay equal across ranks; the frequency mask fills with the
  global minimum (an all-reduce MIN). The logged loss is the global
  batch's, the gradient norm the global gradient's, on every rank.
- ``model``: the kernels ``parallel.param_shardings`` names run
  column- or row-parallel (``parallel.tensor``), each rank holding its
  slice of them and of their Adam moments.
- checkpoints: full tensors, written by rank 0, then a barrier; a
  checkpoint of any mesh resumes on any other, or on one device.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ..cfm import TrainingDraws, cfm_training_loss
from ..compat.jax_params import seeded_init_
from ..compat.torch_ckpt import (optim_state_to_reference,
                                 scheduler_state_to_reference,
                                 vector_field_state_from_reference)
from ..config import FlowHighConfig
from ..models import VectorFieldNet
from ..models.melvoco import encode
from ..parallel.mesh import barrier, data_parallel, shard_batch
from ..parallel.tensor import (gather_full, local_slice, shard_linears,
                               sharded_norm)
from ..utils import RowShard, resolve_device
from .optimizer import Optimizer, global_norm, lr_schedule, make_optimizer

STATE_PREFIX = "trainstate_"


@dataclasses.dataclass
class TrainState:
    """``step`` counts micro-steps (one a ``train_step``); ``generator``
    draws the losses' random numbers and dropout masks; ``ddp`` is ``net``
    in its ``DistributedDataParallel`` wrapper under a mesh (None
    without)."""
    step: int
    net: VectorFieldNet
    optimizer: Optimizer
    generator: torch.Generator
    ddp: Optional[torch.nn.Module] = None


class Trainer:
    def __init__(self, config: FlowHighConfig = FlowHighConfig(),
                 mesh=None, cfm_method: Optional[str] = None,
                 results_folder: Optional[str] = None, device=None):
        """``mesh``: None (one device) or a ``parallel`` mesh of ranks,
        every rank building the same trainer; ``device`` this rank's."""
        self.config = config
        self.mesh = mesh
        # a mesh without a process group (one process) runs no collective
        self._dp = mesh is not None and mesh.group("data") is not None
        self._rank = dist.get_rank() if self._dp else 0
        self._sharded: dict = {}  # parameter name -> dim sharded on
        self.cfm_method = cfm_method or config.cfm.cfm_method
        self.model_cfg = dataclasses.replace(
            config.model, compute_dtype=config.train.amp_dtype)
        self.schedule = lr_schedule(config.train)
        self.results_folder = Path(results_folder or config.train.save_dir)
        self.device = resolve_device(device)

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[dict] = None) -> TrainState:
        """A fresh state: the net from ``seeded_init_(seed)`` (default
        ``TrainConfig.random_seed``) or from ``params`` (a state dict, as
        ``load_params`` returns), the optimizer, and a generator on the
        device seeded with ``seed``."""
        seed = self.config.train.random_seed if seed is None else seed
        net = VectorFieldNet(self.model_cfg)
        if params is None:
            seeded_init_(net, seed)
        else:
            net.load_state_dict(params)
        net.null_cond.requires_grad_(True)
        norm = None
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            # this rank's slices of the kernels the rule shards
            self._sharded = shard_linears(net, self.mesh)
        if self._sharded:
            norm = sharded_norm([n in self._sharded for n, _ in
                                 net.named_parameters()],
                                self.mesh.group("model"))
        net.to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ddp = None
        if self._dp:
            # the null condition has no gradient without the condition drop
            ddp = data_parallel(net, self.mesh, find_unused_parameters=(
                self.config.cfm.cond_drop_prob <= 0))
        return TrainState(0, net, make_optimizer(
            self.config.train, net.parameters(), norm), gen, ddp)

    # -- the train step ---------------------------------------------------------

    def _batch(self, batch: dict):
        dev = self.device
        return (torch.as_tensor(batch["wave"], dtype=torch.float32).to(dev),
                torch.as_tensor(batch["cond"], dtype=torch.float32).to(dev),
                torch.as_tensor(batch["lengths"]).to(dev, torch.int64))

    def _loss_fn(self, net, wave, cond_wav, lengths, *, train: bool = True,
                 draws: Optional[TrainingDraws] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        mel = cfg.mel
        peak = torch.amax(torch.abs(cond_wav), dim=-1, keepdim=True)
        cond_wav = cond_wav / torch.clamp(peak, min=1e-8)
        with torch.no_grad():
            x1, cond = encode(wave, mel), encode(cond_wav, mel)
        mel_len = torch.ceil((lengths - mel.win_length) / mel.hop_length + 1)
        mel_len = torch.clamp(mel_len.to(torch.int64), 1, x1.shape[1])
        return cfm_training_loss(
            net, x1, cond, mel_len, method=self.cfm_method,
            sigma=cfg.cfm.sigma,
            out_size=2 * mel.sampling_rate // mel.hop_length,  # 200 = 2 s
            cond_drop_prob=cfg.cfm.cond_drop_prob,
            weighted=cfg.train.weighted_loss,
            cond_freq_masking=cfg.train.cond_freq_masking, train=train,
            draws=draws, generator=generator)

    def _rows(self, batch: dict, generator):
        """(this rank's rows of ``batch``, the generator to draw with):
        under data parallelism the ``data`` index's share and a
        ``RowShard``; otherwise both as they are."""
        if not self._dp:
            return batch, generator
        return shard_batch(self.mesh, batch), RowShard(
            generator, self.mesh.index("data"), self.mesh.shape["data"],
            self.mesh.group("data"))

    def _global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ``data`` group of each rank's ``x`` (its
        share's mean): the global batch's, on every rank."""
        if not self._dp:
            return x.detach()
        x = x.detach().clone()
        dist.all_reduce(x, group=self.mesh.group("data"))
        return x / self.mesh.shape["data"]

    def train_step(self, state: TrainState, batch: dict,
                   draws: Optional[TrainingDraws] = None):
        """One micro-step on ``batch`` (``wave``, ``cond`` [B, N] at the
        mel rate, ``lengths`` [B]; under a mesh the global batch, or this
        rank's rows from ``parallel.shard_global_batch``); ``draws`` (the
        global batch's) replaces the loss's draws from the state's
        generator. Returns (state, {"loss", "grad_norm"}) with device
        scalars; ``grad_norm`` is this micro-step's gradient norm before
        clipping."""
        net = state.net
        net.zero_grad(set_to_none=True)
        batch, gen = self._rows(batch, state.generator)
        loss = self._loss_fn(state.ddp or net, *self._batch(batch),
                             train=True, draws=draws, generator=gen)
        loss.backward()
        if self._sharded:
            gnorm = state.optimizer.norm([
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in net.parameters()])
        else:
            gnorm = global_norm([p.grad for p in net.parameters()
                                 if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        return state, {"loss": self._global_mean(loss),
                       "grad_norm": gnorm}

    # -- validation ---------------------------------------------------------------

    def evaluate(self, state: TrainState, batches) -> dict:
        """Validation loss over ``batches``: eval mode (no dropout), no
        gradient, the draws of batch i from a generator seeded i (the same
        on every call); the per-batch losses stay on the device and are
        read back once."""
        losses = []
        with torch.no_grad():
            for i, batch in enumerate(batches):
                rows, gen = self._rows(batch, torch.Generator(
                    device=self.device).manual_seed(i))
                losses.append(self._loss_fn(state.net, *self._batch(rows),
                                            train=False, generator=gen))
        vals = self._global_mean(torch.stack(losses)).double().cpu().numpy()
        return {"valid_loss": float(vals.mean()), "n_batches": len(losses)}

    # -- loop -------------------------------------------------------------------

    def latest_checkpoint(self) -> Optional[Path]:
        """The newest ``trainstate_<step>.pt`` in the results folder."""
        cands = sorted(self.results_folder.glob(STATE_PREFIX + "*.pt"),
                       key=lambda p: int(p.stem[len(STATE_PREFIX):]))
        return cands[-1] if cands else None

    def fit(self, data_iter: Iterator[dict],
            state: Optional[TrainState] = None,
            num_steps: Optional[int] = None, log_every: Optional[int] = None,
            save_every: Optional[int] = None, log_fn=print,
            auto_resume: bool = False, tensorboard: bool = False,
            valid_batches=None,
            eval_every: Optional[int] = None) -> TrainState:
        """Train to ``num_steps`` optimizer updates (default
        ``num_train_steps``), as the JAX trainer's ``fit``: every count
        (``num_steps``, the log / save / eval cadences, the logged lr) is
        in updates, each of ``grad_accum_every`` micro-batches from
        ``data_iter``. Appends ``{"step", "loss", "lr", "grad_norm",
        "steps_per_sec"}`` every ``log_every`` updates and ``{"step",
        "valid_loss"}`` every ``eval_every`` (with ``valid_batches``, a
        list or a callable returning one) to ``metrics.jsonl``; saves every
        ``save_every``. ``auto_resume`` restarts from the newest
        ``trainstate_*.pt`` of the results folder when there is one."""
        cfg = self.config.train
        k = max(cfg.grad_accum_every, 1)
        num_steps = num_steps or cfg.num_train_steps
        log_every = log_every or cfg.log_every
        save_every = save_every or cfg.save_model_every
        eval_every = eval_every or cfg.save_results_every
        if state is None:
            state = self.init_state()
            if auto_resume:
                ckpt = self.latest_checkpoint()
                if ckpt is not None:
                    log_fn(f"[train] auto-resuming from {ckpt}")
                    state = self.restore_state(ckpt, state)
                    log_fn(f"[train] restored full state at step {state.step}")

        self.results_folder.mkdir(parents=True, exist_ok=True)
        tb_writer = None
        if tensorboard and self._rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                tb_writer = SummaryWriter(str(self.results_folder / "tb"))
            except ImportError:
                log_fn("[train] tensorboard requested but the tensorboard "
                       "package is missing")
        metrics_path = self.results_folder / "metrics.jsonl"
        t0 = time.time()
        start = state.step
        try:
            for i in range(start, num_steps * k):
                state, metrics = self.train_step(state, next(data_iter))
                if (i + 1) % k:
                    continue  # mid-accumulation: no update applied
                upd = (i + 1) // k
                if upd % log_every == 0:
                    line = {"step": upd, "loss": float(metrics["loss"]),
                            "lr": float(self.schedule(upd - 1)),
                            "grad_norm": float(metrics["grad_norm"]),
                            "steps_per_sec": (upd - start // k)
                            / (time.time() - t0)}
                    self._log(line, "[train]", log_fn,
                              metrics_path if self._rank == 0 else None)
                    if tb_writer is not None:
                        tb_writer.add_scalar("training/cfm_loss",
                                             line["loss"], upd)
                        tb_writer.add_scalar("training/lr", line["lr"], upd)
                if (valid_batches is not None and eval_every
                        and upd % eval_every == 0):
                    batches = (valid_batches() if callable(valid_batches)
                               else valid_batches)
                    vm = self.evaluate(state, batches)
                    line = {"step": upd, "valid_loss": vm["valid_loss"]}
                    self._log(line, "[valid]", log_fn,
                              metrics_path if self._rank == 0 else None)
                    if tb_writer is not None:
                        tb_writer.add_scalar("validation/cfm_loss",
                                             vm["valid_loss"], upd)
                if save_every and upd % save_every == 0:
                    self.save(state)
        finally:
            if tb_writer is not None:
                tb_writer.close()
        return state

    @staticmethod
    def _log(line: dict, tag: str, log_fn, path: Optional[Path]) -> None:
        """``line`` to ``log_fn`` (every rank) and to ``path`` (rank 0's)."""
        log_fn(f"{tag} {line}")
        if path is not None:
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")

    # -- checkpointing ----------------------------------------------------------

    def _updates(self, state: TrainState) -> int:
        """Optimizer updates applied: micro-steps // grad_accum_every."""
        return state.step // max(self.config.train.grad_accum_every, 1)

    def _index_dims(self, state: TrainState) -> dict:
        """{optimizer state index: the dim its parameter is sharded on}
        (torch numbers the parameters group by group)."""
        names = {id(p): n for n, p in state.net.named_parameters()}
        params = [p for g in state.optimizer.inner.param_groups
                  for p in g["params"]]
        return {i: self._sharded[names[id(p)]] for i, p in enumerate(params)
                if names[id(p)] in self._sharded}

    def _reshard(self, state: TrainState, net_sd: dict, opt_sd: dict, fn):
        """``net_sd`` and ``opt_sd`` with ``fn(tensor, mesh, dim)`` applied
        to each sharded parameter's entries (its weights, Adam moments and
        accumulated gradient)."""
        mesh, dims = self.mesh, self._sharded
        net_sd = {k: fn(v, mesh, dims.get(k)) for k, v in net_sd.items()}
        idx = self._index_dims(state)
        opt_sd = dict(opt_sd, inner=dict(opt_sd["inner"], state={
            i: {k: fn(v, mesh, idx.get(i)) if torch.is_tensor(v) and v.ndim
                else v for k, v in st.items()}
            for i, st in opt_sd["inner"]["state"].items()}))
        if opt_sd["acc"] is not None:
            names = [n for n, _ in state.net.named_parameters()]
            opt_sd["acc"] = [fn(a, mesh, dims.get(n))
                             for a, n in zip(opt_sd["acc"], names)]
        return net_sd, opt_sd

    def _whole(self, state: TrainState) -> TrainState:
        """``state`` with whole tensors: itself without tensor parallelism,
        else a copy on the CPU gathered over ``model`` (every rank of the
        mesh calls it)."""
        if not self._sharded:
            return state
        net_sd, opt_sd = self._reshard(
            state, state.net.state_dict(), state.optimizer.state_dict(),
            lambda t, mesh, dim: gather_full(t, mesh, dim).cpu())
        net = VectorFieldNet(self.model_cfg)
        net.load_state_dict(net_sd)
        net.null_cond.requires_grad_(True)
        optimizer = make_optimizer(self.config.train, net.parameters())
        optimizer.load_state_dict(opt_sd)
        return TrainState(state.step, net, optimizer, state.generator)

    def save(self, state: TrainState, folder: Optional[Path] = None) -> Path:
        """The whole state as ``trainstate_<micro-step>.pt`` and the
        reference package as ``FLowHigh.<updates>.pt``; returns the
        first's path. Under a mesh every rank calls it; rank 0 writes full
        tensors, and every rank returns after the files exist."""
        folder = Path(folder or self.results_folder)
        path = folder / f"{STATE_PREFIX}{state.step}.pt"
        whole = self._whole(state)
        if self._rank == 0:
            folder.mkdir(parents=True, exist_ok=True)
            torch.save({"step": whole.step, "net": whole.net.state_dict(),
                        "optimizer": whole.optimizer.state_dict(),
                        "generator": whole.generator.get_state()}, path)
            self._export(whole,
                         folder / f"FLowHigh.{self._updates(whole)}.pt")
        if self._dp:
            barrier(self.mesh)
        return path

    def restore_state(self, path, template: TrainState) -> TrainState:
        """``template`` (a fresh ``init_state``) with the whole state of
        ``save``'s file at ``path`` loaded into it (this rank's slices of
        it under tensor parallelism)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        net_sd, opt_sd = sd["net"], sd["optimizer"]
        if self._sharded:
            net_sd, opt_sd = self._reshard(template, net_sd, opt_sd,
                                           local_slice)
        template.net.load_state_dict(net_sd)
        template.optimizer.load_state_dict(opt_sd)
        template.generator.set_state(sd["generator"])
        template.step = int(sd["step"])
        return template

    def export_torch(self, state: TrainState, path) -> None:
        """The reference's package ``{'model', 'optim', 'scheduler'}``:
        ``flowhigh.``-prefixed parameters, the Adam state in the
        reference's order (no entry for ``null_cond``) and the cosine
        scheduler, both stamped with the updates applied. Under a mesh
        every rank calls it and rank 0 writes."""
        whole = self._whole(state)
        if self._rank == 0:
            self._export(whole, path)
        if self._dp:
            barrier(self.mesh)

    def _export(self, state: TrainState, path) -> None:
        step = self._updates(state)
        sd = {"flowhigh." + k: v.detach().cpu()
              for k, v in state.net.state_dict().items()}
        optim = optim_state_to_reference(
            state.net, state.optimizer.inner, self.model_cfg,
            self.config.train, step)
        sched = scheduler_state_to_reference(self.config.train, step,
                                             last_lr=self.schedule(step))
        torch.save({"model": sd, "optim": optim, "scheduler": sched}, path)

    def load_params(self, path) -> dict:
        """The net's state dict from a reference package (``FLowHigh.*.pt``
        of either package's ``export_torch``, or a published checkpoint)
        or from ``save``'s ``trainstate_*.pt``."""
        path = Path(path)
        if path.is_dir():
            raise ValueError(
                f"{path} is a directory: an orbax checkpoint of the JAX "
                "package, which this package cannot read; load the "
                "FLowHigh.<step>.pt package that the JAX trainer's save "
                "writes beside it")
        pkg = torch.load(path, map_location="cpu", weights_only=True)
        if "net" in pkg:
            return pkg["net"]
        return vector_field_state_from_reference(
            pkg["model"], VectorFieldNet(self.model_cfg).state_dict())


__all__ = ["Trainer", "TrainState"]
