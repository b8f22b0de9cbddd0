"""Tensor parallelism over a mesh's ``model`` axis: the vector field's wide
Linears, sharded by ``mesh.param_shardings`` (the JAX package's
``_kernel_spec``), computed as GSPMD lays them out.

The field calls its projections through ``models.transformer.dense``, not
as modules, so module hooks (``parallelize_module``) would never fire;
``shard_linears`` swaps each sharded ``nn.Linear`` for a ``ParallelLinear``
holding this rank's slice of the weight, and ``dense`` hands it the call:

- column-parallel (weight dim 0, the JAX kernel's outputs): this rank's
  output columns, all-gathered over ``model`` in rank order (so the fused
  q | k | v split sees the whole row), then the replicated bias;
- row-parallel (weight dim 1, the inputs): this rank's slice of the input
  times its slice of the weight, a partial sum all-reduced over ``model``,
  then the bias. Below float32 the partial sums are float32 products of the
  ``dtype`` values and round to ``dtype`` once, after the reduction, as the
  unsharded product rounds its float32 sum once.

The math is the layer's; only the layout moves, and the sums group in
another order. The collectives carry gradients (Megatron's f / g pairs):
the input of a column-parallel layer all-reduces its gradient over
``model``, a gather's gradient is this rank's slice, a split's gradient is
all-gathered, and a reduction's gradient passes through; so every
replicated parameter gets the same gradient on every rank of a ``model``
group, and each sharded weight the gradient of its slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, param_shardings


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    """Forward: identity; backward: the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the ranks' last-dim slices joined in rank order; backward:
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.n, ctx.index = n, index
        return _gather(x, group, n, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.index].contiguous(), None, None, None


class _SplitToModel(torch.autograd.Function):
    """Forward: this rank's last-dim slice; backward: the slices' gradients
    joined over ``model``."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.n = group, n
        return x.chunk(n, dim=-1)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, -1), None, None, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the sum over ``model``; backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ParallelLinear(nn.Module):
    """An ``nn.Linear`` whose weight is sharded over ``model`` on ``dim``
    (0: column-parallel, 1: row-parallel); the bias stays whole. Its state
    dict holds this rank's slice under the Linear's names."""

    def __init__(self, layer: nn.Linear, mesh: Mesh, dim: int):
        super().__init__()
        self.group = mesh.group("model")
        self.n, self.index = mesh.shape["model"], mesh.index("model")
        self.dim = dim
        self.in_features, self.out_features = (layer.in_features,
                                               layer.out_features)
        w = layer.weight.detach().chunk(self.n, dim=dim)[self.index]
        self.weight = nn.Parameter(w.clone())
        self.bias = (None if layer.bias is None
                     else nn.Parameter(layer.bias.detach().clone()))

    def forward(self, x):
        return self.dense(x, torch.float32)

    def dense(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``models.transformer.dense`` of the whole layer at ``dtype``."""
        lowp = dtype != torch.float32
        if self.dim == 0:
            x = _CopyToModel.apply(x, self.group)
            y = (F.linear(x.to(dtype), self.weight.to(dtype)) if lowp
                 else F.linear(x, self.weight))
            y = _GatherFromModel.apply(y, self.group, self.n, self.index)
        else:
            x = _SplitToModel.apply(x, self.group, self.n, self.index)
            y = (F.linear(x.to(dtype).float(), self.weight.to(dtype).float())
                 if lowp else F.linear(x, self.weight))
            y = _ReduceFromModel.apply(y, self.group)
            if lowp:
                y = y.to(dtype)
        if self.bias is None:
            return y
        return y + (self.bias.to(dtype) if lowp else self.bias)


def shard_linears(net: nn.Module, mesh: Mesh) -> dict:
    """Swap every Linear whose weight ``param_shardings`` shards for a
    ``ParallelLinear`` holding this rank's slice, in place; returns
    {parameter name: the dim it is sharded on} (empty without a ``model``
    axis)."""
    dims = {name: sh.spec.index("model")
            for name, sh in param_shardings(mesh, net).items()
            if "model" in sh.spec}
    for name, dim in dims.items():
        path = name.rsplit(".", 1)[0]
        parent_path, _, child = path.rpartition(".")
        parent = net.get_submodule(parent_path) if parent_path else net
        layer = parent.get_submodule(child)
        if not isinstance(layer, nn.Linear):
            raise TypeError(f"{path} is sharded but is no nn.Linear: {layer}")
        setattr(parent, child, ParallelLinear(layer, mesh, dim))
    return dims


def gather_full(t: torch.Tensor, mesh: Mesh, dim: Optional[int]) -> torch.Tensor:
    """The whole tensor of this rank's slice ``t`` (sharded on ``dim`` over
    ``model``; None: whole already)."""
    if dim is None or mesh.shape["model"] == 1:
        return t
    return _gather(t.movedim(dim, -1), mesh.group("model"),
                   mesh.shape["model"], -1).movedim(-1, dim)


def local_slice(t: torch.Tensor, mesh: Mesh, dim: Optional[int]) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` (sharded on ``dim``)."""
    if dim is None or mesh.shape["model"] == 1:
        return t
    return t.chunk(mesh.shape["model"], dim=dim)[mesh.index("model")].clone()


def sharded_norm(flags: list, group):
    """The global norm of gradients of which those flagged hold this rank's
    slice of a ``model``-sharded weight: the replicated ones counted once,
    the slices' squares summed over ``model``."""
    def norm(tensors) -> torch.Tensor:
        rep = [torch.linalg.vector_norm(t) for t, s in zip(tensors, flags)
               if not s]
        part = torch.stack([torch.linalg.vector_norm(t) for t, s
                            in zip(tensors, flags) if s])
        sq = _all_reduce(torch.sum(part * part), group)
        total = torch.sum(torch.stack(rep) ** 2) if rep else torch.zeros_like(sq)
        return torch.sqrt(total + sq)
    return norm
