"""One rank of the port's multi-process CPU runs (tests/test_torch_parallel.py).

Run as ``python tests/torch_parallel_ranks.py JOB DIR`` once per rank, with
torchrun's environment set by hand (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); the ranks join over gloo through
``parallel.initialize(device="cpu")``. Inputs come from ``DIR/inputs.pt``
(written by the test); each rank writes ``DIR/<JOB>_rank<r>.pt`` and
prints ``RANK_OK <r>``. Imports torch and the port only.

Jobs:
- ``dp``: a mesh of 2 x 1 (world 2): a ``Trainer`` step on the global
  batch and one on ``shard_global_batch``'s local rows, a save, a
  ``VocoderTrainer`` step, ``make_sharded_generate`` and
  ``StreamingSR.generate_sharded`` (twice).
- ``tp``: a mesh of 2 x 2 (world 4): the ``Trainer`` step with the field's
  kernels sharded over ``model`` (float32, then bf16 compute), a save,
  ``make_sharded_generate``.
"""

import os
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from flowhigh_tpu_torch import FlowHighSR, StreamingSR  # noqa: E402
from flowhigh_tpu_torch.config import (CFMConfig, FlowHighConfig,  # noqa: E402
                                       ModelConfig, TrainConfig,
                                       VocoderConfig)
from flowhigh_tpu_torch.parallel import (initialize,  # noqa: E402
                                         local_batch_slice, make_global_mesh,
                                         shard_global_batch)
from flowhigh_tpu_torch.train import Trainer, VocoderTrainer  # noqa: E402


def trainer_step(inp: dict, mesh, folder: Path, local_rows: bool,
                 amp: str = "float32") -> dict:
    c = inp["trainer"]
    cfg = FlowHighConfig().replace(
        model=ModelConfig(**c["field"]), cfm=CFMConfig(**c["cfm"]),
        train=TrainConfig(**dict(c["train"], amp_dtype=amp)))
    tr = Trainer(cfg, mesh=mesh, results_folder=str(folder), device="cpu")
    state = tr.init_state(0, params=c["params"])
    batch = c["batch"]
    if local_rows:  # what batch_iterator(process_index=...) hands a rank
        rows = local_batch_slice(len(batch["wave"]), mesh.index("data"),
                                 mesh.shape["data"])
        batch = shard_global_batch(mesh, {k: v[rows]
                                          for k, v in batch.items()})
    state, m = tr.train_step(state, batch, draws=c["draws"])
    whole = tr._whole(state)
    return {"trainer": tr, "state": state,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: v.detach().clone()
                       for k, v in whole.net.state_dict().items()},
            "local_shapes": {k: tuple(v.shape)
                             for k, v in state.net.state_dict().items()}}


def vocoder_step(inp: dict, mesh) -> dict:
    c = inp["vocoder"]
    tr = VocoderTrainer(VocoderConfig(**c["config"]), mesh=mesh,
                        device="cpu", **c["kw"])
    state = tr.init_state(0)
    state, m = tr.train_step(state, c["batch"])
    params = {f"{name}.{k}": v.detach().clone()
              for name in ("generator", "mpd", "mrd")
              for k, v in getattr(state, name).named_parameters()}
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": params}


def serving(inp: dict, mesh, streaming: bool) -> dict:
    c = inp["serving"]
    cfg = FlowHighConfig().replace(model=ModelConfig(**c["field"]),
                                   vocoder=VocoderConfig(**c["vocoder"]))
    sr = FlowHighSR(cfg, cfm_method="independent_cfm_adaptive",
                    ode_method="euler", device="cpu")
    sr.net.load_state_dict(c["net"])
    sr.vocoder.load_state_dict(c["voc"])
    fn = sr.make_sharded_generate(mesh, in_sr=16000)
    out, n48 = fn(c["batch"], c["lens"], seed=3)
    res = {"out": out.clone(), "n48": n48.clone()}
    if streaming:
        s = StreamingSR(sr, chunk_seconds=1.0, overlap_seconds=0.25)
        res["long"] = s.generate_sharded(c["long"], 16000, mesh, seed=2)
        res["long_again"] = s.generate_sharded(c["long"], 16000, mesh,
                                               seed=2)
        res["cache_entries"] = len(s._sharded_fns)
        fn = s._sharded_fns[(mesh.key, 16000, 48000, 1)]
        res["chunks"] = fn(c["chunks"], c["chunk_lens"], seed=2)[0].clone()
    return res


def main() -> None:
    job, folder = sys.argv[1], Path(sys.argv[2])
    rank, world = initialize(device="cpu")
    inp = torch.load(folder / "inputs.pt", weights_only=False)
    res = {"rank": rank, "world": world}
    if job == "dp":
        mesh = make_global_mesh()
        res["mesh"] = dict(mesh.shape)
        t = trainer_step(inp, mesh, folder / "dp_ckpt", local_rows=False)
        res["trainer"] = {k: t[k] for k in ("loss", "grad_norm", "params")}
        t["trainer"].save(t["state"])
        res["saved"] = sorted(p.name for p in (folder / "dp_ckpt").iterdir())
        t2 = trainer_step(inp, mesh, folder / "unused", local_rows=True)
        res["trainer_local_rows"] = {k: t2[k] for k in ("loss", "params")}
        res["vocoder"] = vocoder_step(inp, mesh)
        res["serving"] = serving(inp, mesh, streaming=True)
    elif job == "tp":
        mesh = make_global_mesh(n_model=2)
        res["mesh"] = dict(mesh.shape)
        t = trainer_step(inp, mesh, folder / "tp_ckpt", local_rows=False)
        res["trainer"] = {k: t[k] for k in ("loss", "grad_norm", "params",
                                            "local_shapes")}
        t["trainer"].save(t["state"])
        t = trainer_step(inp, mesh, folder / "unused", local_rows=False,
                         amp="bfloat16")
        res["trainer_bf16"] = {k: t[k] for k in ("loss", "params")}
        res["serving"] = serving(inp, mesh, streaming=False)
    else:
        raise ValueError(f"unknown job {job!r}")
    if rank == 0 or job == "tp":
        torch.save(res, folder / f"{job}_rank{rank}.pt")
    else:  # the other ranks: what must equal rank 0's
        torch.save({"rank": rank, "trainer": {"loss": res["trainer"]["loss"]},
                    "serving": res["serving"]},
                   folder / f"{job}_rank{rank}.pt")
    print(f"RANK_OK {rank} of {world} (LOCAL_RANK "
          f"{os.environ.get('LOCAL_RANK')})", flush=True)


if __name__ == "__main__":
    main()
