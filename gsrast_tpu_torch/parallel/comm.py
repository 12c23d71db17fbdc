"""Differentiable collectives over one axis of a (data, tiles) mesh, and the
two boundary rules of `shard_map`, made explicit.

Each collective's backward is its transpose, as JAX differentiates it
inside `shard_map`:
  * `all_to_all` (split and concatenate along dim 0) <-> the reverse
    `all_to_all`;
  * `all_gather` (tiled, along dim 0) <-> a reduce-scatter (sum) of the
    cotangents;
  * `all_reduce_sum` <-> `all_reduce_sum`; `pmean` <-> `pmean`.
The boundaries:
  * `shard_replicated`: this rank's tile-axis shard of a tensor every rank
    holds whole (the sharded paths preprocess 1/D of the Gaussians each).
    Its backward is the sum of the ranks' cotangents over the mesh, which
    `shard_map` inserts for an input replicated over the mesh: an
    all_gather of the disjoint shards over the tile axis, then a sum over
    the data axis.
  * `replicated_input`: a tensor every rank holds and uses whole (the
    legacy tile-sharded paths preprocess all the Gaussians on every rank).
    Its backward is the same sum over the mesh: an all_reduce over the
    tile axis, then over the data axis.
  * `replicated_output`: a value every rank of the mesh holds (an image
    assembled by `all_gather`, a loss after `pmean`). `shard_map` divides
    the cotangent of an output replicated over a mesh axis by that axis's
    size; so does this one's backward, by the mesh's size, since every
    rank runs the backward from its own copy.
With these, a loss's gradient on every rank equals `jax.grad` of the
reference's sharded function.

Transports: NCCL takes CUDA tensors. gloo takes CPU tensors and, for the
three collectives used here (all_to_all_single, all_gather, all_reduce),
CUDA tensors too, copying them through host memory itself (checked on an
H100 with torch 2.11), so ranks that share a card keep their tensors on it.
`transports` records what each collective took last. A group of one rank
runs no collective.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, TILE_AXIS, axis_size

transports: Dict[str, str] = {}


def _record(op: str, x: torch.Tensor, group) -> None:
    transports[op] = f"{dist.get_backend(group)} on {x.device.type} tensors"


def _all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    _record("all_to_all", x, group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    _record("all_gather", x, group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    _record("all_reduce", x, group)
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def _reduce_scatter_raw(x: torch.Tensor, group) -> torch.Tensor:
    """Rank j's chunk of the sum over ranks: the all_to_all of the chunks,
    then their sum in rank order (the same order on every rank)."""
    n = dist.get_world_size(group)
    got = _all_to_all_raw(x, group)
    return got.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).sum(0)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


def _tile_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rows [d n/D, (d+1) n/D) of x, d this rank's tile index."""
    rows = x.shape[0] // axis_size(mesh, TILE_AXIS)
    d = mesh.get_local_rank(TILE_AXIS)
    return x[d * rows:(d + 1) * rows]


class _ShardReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _tile_shard(x, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        for axis, collect in ((TILE_AXIS, _all_gather_raw),
                              (DATA_AXIS, _all_reduce_raw)):
            group = _group_of(ctx.mesh, axis)
            if group is not None:
                g = collect(g, group)
        return g, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for axis in (TILE_AXIS, DATA_AXIS):
            group = _group_of(ctx.mesh, axis)
            if group is not None:
                g = _all_reduce_raw(g, group)
        return g, None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, replicas):
        ctx.replicas = replicas
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.replicas, None


def _group_of(mesh, axis):
    """The axis's group, or None where the axis has one rank."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def all_to_all(x: torch.Tensor, mesh, axis: str = TILE_AXIS) -> torch.Tensor:
    """Chunk j of x's D equal chunks along dim 0 goes to rank j of the
    axis; the result is the received chunks in rank order. Differentiable
    where x is floating."""
    group = _group_of(mesh, axis)
    if group is None:
        return x
    if x.is_floating_point():
        return _AllToAll.apply(x, group)
    return _all_to_all_raw(x, group)


def all_gather(x: torch.Tensor, mesh, axis: str = TILE_AXIS) -> torch.Tensor:
    """The axis's ranks' x concatenated along dim 0, in rank order.
    Differentiable where x is floating: a reduce-scatter backward."""
    group = _group_of(mesh, axis)
    if group is None:
        return x
    if x.is_floating_point():
        return _AllGather.apply(x, group)
    return _all_gather_raw(x, group)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the axis's ranks, on every one of them. Differentiable where
    x is floating (psum's transpose: the same sum)."""
    group = _group_of(mesh, axis)
    if group is None:
        return x
    if x.is_floating_point():
        return _AllReduceSum.apply(x, group)
    return _all_reduce_raw(x, group)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean over the axis's ranks, on every one of them."""
    return all_reduce_sum(x, mesh, axis) / axis_size(mesh, axis)


def shard_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rows [d n/D, (d+1) n/D) of x (n divisible by D), d this rank's tile
    index, where every rank holds the same x. Its backward sums the ranks'
    cotangents over the mesh (module docstring)."""
    if mesh.size() == 1:
        return x
    if not x.is_floating_point():
        return _tile_shard(x, mesh)
    return _ShardReplicated.apply(x, mesh)


def replicated_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """x, which every rank holds and uses whole; its backward sums the
    ranks' cotangents over the mesh (module docstring)."""
    if mesh.size() == 1 or not x.is_floating_point():
        return x
    return _ReplicatedInput.apply(x, mesh)


def replicated_output(x: torch.Tensor, mesh) -> torch.Tensor:
    """x, which every rank of the mesh holds; the backward divides the
    cotangent by the number of ranks (module docstring)."""
    if mesh.size() == 1 or not x.requires_grad:
        return x
    return _ReplicatedOutput.apply(x, mesh.size())
