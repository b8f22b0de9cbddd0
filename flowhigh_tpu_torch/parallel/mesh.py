"""The ``data`` x ``model`` mesh of ranks and its sharding rules —
counterpart of ``flowhigh_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over devices and lets GSPMD
insert the collectives. Here a JAX device is a rank of ``torch.distributed``
(one process per card, ``parallel.distributed``), and the collectives are
explicit: DDP all-reduces gradients over ``data`` (the trainers), the
vector field's wide Linears run column- or row-parallel over ``model``
(``parallel.tensor``), and sharded serving all-gathers its rows over
``data`` (``FlowHighSR.make_sharded_generate``).

``Mesh`` is a small class of its own over ``torch.distributed.new_group``
rather than ``torch.distributed.device_mesh.DeviceMesh``: it reads like the
JAX mesh the callers were written against (``mesh.shape["data"]``,
``dict(mesh.shape) == {"data": n, "model": m}``), it exists before and
without a process group (a single process gets a 1 x 1 mesh that runs no
collective), and its groups are plain process groups on gloo and NCCL
alike. Ranks fill the grid row by row, so the ranks of one ``model`` group
are consecutive and tensor parallelism stays inside a node.

Axes:
- ``data``  — batch sharding (DP): each ``data`` index holds its rows;
  gradients are averaged over the ``data`` group.
- ``model`` — tensor parallelism: the kernels that ``_kernel_spec`` names
  are sharded over the ``model`` group, the rest replicated.
"""

from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compat.jax_params import jax_param_name

AXES = ("data", "model")

_meshes: dict = {}


class Mesh:
    """``ranks`` [n_data, n_model] of the world; this rank's coordinates,
    device and process groups along both axes."""

    def __init__(self, ranks: np.ndarray, groups: Optional[dict] = None):
        self.ranks = np.asarray(ranks, np.int64).reshape(-1, ranks.shape[-1])
        n_data, n_model = self.ranks.shape
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self._groups = groups or {}
        joined = dist.is_initialized()
        rank = dist.get_rank() if joined else 0
        where = np.argwhere(self.ranks == rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        if joined and dist.get_backend() == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu") if joined else None

    @property
    def key(self) -> tuple:
        """The mesh's structure (axes and ranks): a cache key that a new
        mesh of the same layout shares, unlike ``id(mesh)``."""
        return (tuple(self.shape.items()), tuple(self.ranks.flat))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.coords is None:
            raise ValueError(f"this rank is outside the mesh {self.ranks}")
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        """This rank's process group along ``axis``; None where the axis
        holds this rank alone without a process group (no collective)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


def _groups(ranks: np.ndarray) -> dict:
    """Every rank creates every group, in one order (``new_group`` is
    collective); each keeps the two that hold it. A group of the whole
    world is the default group."""
    world = dist.get_world_size()
    me = dist.get_rank()
    mine = {}
    for axis, lines in (("data", ranks.T), ("model", ranks)):
        for line in lines:
            members = [int(r) for r in line]
            group = (dist.group.WORLD if members == list(range(world))
                     else dist.new_group(members))
            if me in members:
                mine[axis] = group
    return mine


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A mesh over the first n_data x n_model ranks (``devices``: the ranks
    to use, default the whole world; a single process without a process
    group is a world of one). Every rank must make the same meshes in the
    same order; a layout made again is the same object."""
    joined = dist.is_initialized()
    ranks = list(range(dist.get_world_size() if joined else 1)) \
        if devices is None else [int(r) for r in np.asarray(devices).flat]
    if n_data is None:  # at least 1: a world too small for n_model fails
        n_data = max(len(ranks) // n_model, 1)
    assert n_data * n_model <= len(ranks), (
        f"mesh {n_data}x{n_model} needs more than {len(ranks)} devices")
    grid = np.asarray(ranks[: n_data * n_model], np.int64).reshape(
        n_data, n_model)
    if not joined:
        return Mesh(grid)
    world = dist.group.WORLD
    key = (n_data, n_model, tuple(grid.flat))
    hit = _meshes.get(key)
    if hit is None or hit[0] is not world:  # a new process group
        hit = (world, Mesh(grid, _groups(grid)))
        _meshes[key] = hit
    return hit[1]


class NamedSharding(NamedTuple):
    """Where a tensor lives on ``mesh``: ``spec`` names, for each tensor
    dimension in turn, the mesh axis it is split over (None: whole);
    ``()`` is replicated. The torch layout's dimensions: a Linear weight is
    [out, in], the transpose of the JAX kernel's [in, out]."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis over ``data``."""
    return NamedSharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


_COLUMN = ("to_qkv", "proj_in")   # in-projections: outputs sharded
_ROW = ("to_out", "proj_out")     # out-projections: inputs sharded


def _kernel_spec(name: str, leaf: torch.Tensor, n_model: int) -> tuple:
    """The JAX package's tensor-parallel rule on the port's parameter
    ``name`` (matched by its JAX name, ``compat.jax_params.jax_param_name``:
    "to_qkv" also matches GateLoop's ``to_qkva``): column-parallel for
    in-projections (the torch weight's dim 0, JAX's output dim), row-parallel
    for out-projections (dim 1, JAX's input dim), each only where the
    dimension divides by ``n_model``; everything else replicated."""
    if n_model <= 1 or leaf.ndim != 2:
        return ()
    jname = jax_param_name(name)
    dout, din = leaf.shape
    if any(k in jname for k in _COLUMN) and dout % n_model == 0:
        return ("model", None)
    if any(k in jname for k in _ROW) and din % n_model == 0:
        return (None, "model")
    return ()


def param_shardings(mesh: Mesh, params: Any) -> dict:
    """{name: NamedSharding} for a module's parameters or a state dict:
    replicate everything except the transformer's wide kernels when a
    ``model`` axis exists."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    n_model = mesh.shape["model"]
    return {name: NamedSharding(mesh, _kernel_spec(name, leaf, n_model))
            for name, leaf in items}


def barrier(mesh: Mesh) -> None:
    """Every rank of ``mesh`` waits until rank 0 arrives: over its
    ``model`` group (rank 0's row waits for it), then over its ``data``
    group (each column for its member of that row)."""
    for axis in ("model", "data"):
        if mesh.group(axis) is not None:
            dist.barrier(group=mesh.group(axis))


def data_parallel(module: torch.nn.Module, mesh: Mesh,
                  find_unused_parameters: bool = False):
    """``module`` in ``DistributedDataParallel`` over ``mesh``'s ``data``
    group, its buffers not broadcast at each forward (every rank builds
    them alike)."""
    ddp = torch.nn.parallel.DistributedDataParallel
    quiet = ({"forward_sync_buffers": False}
             if "forward_sync_buffers" in inspect.signature(ddp).parameters
             else {"broadcast_buffers": False})
    return ddp(module, process_group=mesh.group("data"),
               find_unused_parameters=find_unused_parameters, **quiet)


class ShardedBatch(dict):
    """A batch that already holds only this rank's rows of the global batch
    (``shard_global_batch``, ``shard_batch``)."""

    def __init__(self, mesh: Mesh, rows: dict):
        super().__init__(rows)
        self.mesh = mesh


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows (its ``data`` index's share) of a host batch, on its
    device: a dict of arrays becomes a ``ShardedBatch``, an array a tensor.
    The batch must divide over ``data``; a ``ShardedBatch`` comes back as
    it is."""
    if isinstance(batch, ShardedBatch):
        return batch
    n_data = mesh.shape["data"]
    d = mesh.index("data")

    def rows(x):
        x = torch.as_tensor(x)
        b = x.shape[0]
        assert b % n_data == 0, (
            f"global batch {b} must divide over {n_data} processes")
        x = x[d * (b // n_data):(d + 1) * (b // n_data)]
        return x if mesh.device is None else x.to(mesh.device)

    if isinstance(batch, dict):
        return ShardedBatch(mesh, {k: rows(v) for k, v in batch.items()})
    return rows(batch)
