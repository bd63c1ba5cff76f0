"""The collectives of the sharded step, and their autograd pairs.

JAX gets a collective's backward from ``shard_map``'s transpose; here
each is a ``torch.autograd.Function`` with Megatron's pair:

- :func:`copy_to_model` — identity forward, all-reduce backward (the
  entry of a tensor-parallel region; :func:`copy_to_group` takes the
  group itself, as the vocabulary-parallel head does);
- :func:`reduce_from_model` — all-reduce forward, identity backward (its
  exit: the row-parallel projection's partial sums);
- :func:`scatter_seq` — reduce-scatter over L forward, all-gather
  backward (the exit under sequence parallelism);
- :func:`gather_seq` — all-gather over L forward, reduce-scatter
  backward (the entry under sequence parallelism);
- :func:`split` / :func:`unsplit` — a replicated tensor's own slice
  along a dimension, with an all-gather backward, and the reverse (where
  the sequence-parallel region starts and ends, over L; a sharded
  weight gathered whole for an attention that runs replicated).

Every function takes the mesh and acts over its model group; with one
model rank each is the identity. The plain collectives below them act
on any group and run on the group's backend as they are: nccl on the
card, gloo on the CPU and for several ranks sharing one card (torch
2.11's gloo takes every collective here on CUDA tensors; a build that
refused one would raise, not reroute).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``group`` (None: nothing to do)."""
    if group_size(group) > 1:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast_(tensor: torch.Tensor, group) -> torch.Tensor:
    """In place: the group's first rank's ``tensor`` on every rank of it."""
    if group_size(group) > 1:
        dist.broadcast(tensor, dist.get_global_rank(group, 0), group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``tensor``s concatenated along ``dim``, in rank order."""
    n = group_size(group)
    if n == 1:
        return tensor
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts, dim)


def _sizes(tensor: torch.Tensor, group, dim: int) -> list[int]:
    """Every rank's size of ``tensor`` along ``dim``, in rank order."""
    size = torch.tensor([tensor.shape[dim]], dtype=torch.int64, device=tensor.device)
    return all_gather(size, group).tolist()


def all_gather_uneven(tensor: torch.Tensor, group, dim: int = 0, sizes=None) -> torch.Tensor:
    """:func:`all_gather` of pieces whose sizes along ``dim`` may differ
    (a vocabulary the model axis does not divide): each piece is padded
    to the largest for the collective and cut back after it. ``sizes``:
    the ranks' sizes, where the caller has them."""
    n = group_size(group)
    if n == 1:
        return tensor
    sizes = _sizes(tensor, group, dim) if sizes is None else sizes
    top = max(sizes)
    if top == min(sizes):
        return all_gather(tensor, group, dim)
    shape = list(tensor.shape)
    shape[dim] = top
    padded = tensor.new_zeros(shape)
    padded.narrow(dim, 0, tensor.shape[dim]).copy_(tensor)
    parts = all_gather(padded, group, dim).split(top, dim)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)], dim)


def reduce_scatter(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk (along ``dim``) of the ranks' summed ``tensor``."""
    n = group_size(group)
    if n == 1:
        return tensor
    parts = [c.contiguous() for c in tensor.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def reduce_int(value: int, group, device, op=dist.ReduceOp.SUM) -> int:
    """A host int reduced over ``group`` (one tiny collective)."""
    if group_size(group) == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    return int(all_reduce_(t, group, op)[0])


def _own(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    return t.chunk(group_size(group), dim)[group_rank(group)].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, 1), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, 1), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Unsplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim), None, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        sizes = _sizes(x, group, -1)
        ctx.start, ctx.size = sum(sizes[:group_rank(group)]), x.shape[-1]
        return all_gather_uneven(x, group, x.dim() - 1, sizes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.start, ctx.size).contiguous(), None


def _apply(fn, x, mesh, *args):
    if mesh is None or mesh.model == 1:
        return x
    return fn.apply(x, mesh.model_group, *args)


def copy_to_group(x, group):
    """Identity forward, the gradient all-reduced over ``group`` (None:
    the identity)."""
    return x if group_size(group) == 1 else _CopyToModel.apply(x, group)


def copy_to_model(x, mesh):
    return copy_to_group(x, None if mesh is None else mesh.model_group)


def reduce_from_model(x, mesh):
    return _apply(_ReduceFromModel, x, mesh)


def scatter_seq(x, mesh):
    return _apply(_ScatterSeq, x, mesh)


def gather_seq(x, mesh):
    return _apply(_GatherSeq, x, mesh)


def gather_vocab(x, group):
    """The ranks' slices of ``x`` along its last dimension (a
    vocabulary-parallel head's logits), whole, uneven slices included;
    the gradient is this rank's slice of the (equal) gradients."""
    return x if group_size(group) == 1 else _GatherVocab.apply(x, group)


def split(x, mesh, dim: int = 1):
    """This model rank's chunk of a replicated ``x`` along ``dim``; the
    gradient is all-gathered."""
    return _apply(_Split, x, mesh, dim)


def unsplit(x, mesh, dim: int = 1):
    """The model ranks' chunks of ``x`` along ``dim``, whole, where every
    rank goes on with the same replicated computation: the gradient is
    this rank's chunk of the (equal) gradients."""
    return _apply(_Unsplit, x, mesh, dim)
