"""Multi-process entry point — counterpart of
``flowhigh_tpu/parallel/distributed.py``.

The JAX package joins one coordination service per host process and
builds one ``Mesh`` over the global device list. PyTorch's idiom is one
process per card (a **rank** of ``torch.distributed``), as the reference's
``accelerate launch`` DDP run: ``torchrun --nproc_per_node=N`` starts the
ranks and sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``; each rank calls ``initialize()`` and then builds the
same mesh (``make_global_mesh``), whose ranks stand where the JAX mesh's
devices stand.

What runs where:

- ``initialize()`` — once per process, before any mesh: NCCL on the card
  (each rank on ``cuda:LOCAL_RANK``), gloo when the caller asks for the CPU
  (``device="cpu"``, as the tests do). There is no fallback from one to the
  other: a launch without a card that does not ask for the CPU raises.
- ``make_global_mesh()`` — the same on every rank: ``data`` x ``model`` over
  the whole world.
- ``batch_iterator(..., process_index=<data index>, process_count=<n_data>)``
  (``train.data``) — the ``data`` group's disjoint slices of one shared
  global shuffle; the ranks of one ``model`` group read the same rows.
- ``shard_global_batch`` — marks those local rows as this rank's share of
  the global batch, on its device, for a trainer under the mesh.
- checkpoints — rank 0 writes full tensors, every rank waits at a barrier
  (``Trainer.save``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import ShardedBatch, make_mesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _launch_env() -> Optional[dict]:
    """torchrun's variables, or None outside a launch (no ``WORLD_SIZE``)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE is set but {missing} are not: launch with torchrun, "
            "or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK yourself")
    return {"address": f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}",
            "world": int(os.environ["WORLD_SIZE"]),
            "rank": int(os.environ["RANK"]),
            "local": int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *, device=None) -> tuple[int, int]:
    """Join the process group; returns (process_index, process_count).

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), where the
    JAX package reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``; the JAX package's explicit form
    ``initialize("host:port", n, rank)`` works too. A single process with
    neither is a no-op that returns (0, 1) and joins nothing. Idempotent:
    once joined, it returns the group's (rank, size).

    ``device``: None or "cuda" joins over NCCL and puts this rank on its
    card (``local_device_ids[0]``, else ``LOCAL_RANK``, else the rank modulo
    the cards); "cpu" joins over gloo. Joining without a card and without
    ``device="cpu"`` raises; nothing falls back to gloo on its own.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = _launch_env() if coordinator_address is None else None
    if coordinator_address is None and env is None:
        return 0, 1  # single process: nothing to join
    if env is not None:
        coordinator_address = coordinator_address or env["address"]
        num_processes = env["world"] if num_processes is None else num_processes
        process_id = env["rank"] if process_id is None else process_id
    if num_processes is None or process_id is None:
        raise ValueError("initialize(coordinator_address, num_processes, "
                         "process_id): the process count and this process's "
                         "index are needed with an explicit address")
    kind = torch.device(device).type if device is not None else "cuda"
    if kind not in _BACKEND:
        raise ValueError(f"initialize joins ranks on 'cuda' or 'cpu', got "
                         f"{device!r}")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize joins the ranks over NCCL on the card and no CUDA "
                "device is available; pass device='cpu' to join over gloo")
        if local_device_ids is not None:
            local = int(list(local_device_ids)[0])
        elif env is not None:
            local = env["local"]
        else:
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(_BACKEND[kind],
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def make_global_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A mesh over the whole world (every rank, after ``initialize()``).
    The ranks of one ``model`` group are consecutive, so that tensor
    parallelism stays inside a node under torchrun's numbering."""
    return make_mesh(n_data=n_data, n_model=n_model)


def local_batch_slice(global_batch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """Rows of a size-``global_batch`` batch owned by this process.
    The global batch must divide evenly (static shapes everywhere)."""
    joined = dist.is_initialized()
    pi = (dist.get_rank() if joined else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if joined else 1) if process_count is None \
        else process_count
    assert global_batch % pc == 0, (
        f"global batch {global_batch} must divide over {pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def shard_global_batch(mesh, local_batch) -> ShardedBatch:
    """This rank's rows of the global batch (e.g. from ``batch_iterator(...,
    process_index=mesh.index("data"), process_count=mesh.shape["data"])``)
    on its device, marked as such: a trainer under ``mesh`` takes them as
    its share without slicing them again (a plain dict is a global batch,
    which it slices)."""
    return ShardedBatch(mesh, {k: torch.as_tensor(v).to(mesh.device)
                               for k, v in local_batch.items()})
