"""Collectives as differentiable functions, for one process per rank.

Two conventions meet in a mesh. Across `model`, `context` and `pipe` every
rank of a group computes the same loss on the same activations (they are
replicated there, as GSPMD leaves them), so a gradient that arrives at a
collective is the same on every rank of its group. Across `data` and
`fsdp` each rank computes the loss of its own slice of the batch and the
trainer averages the gradients over the group afterwards, so a collective
there hands each rank's share of the sum back to its owner.

- `copy_to(x, group)`: identity forward, all-reduce of the gradient (the
  input of a column-parallel product);
- `reduce_from(x, group)`: all-reduce forward, identity backward (the
  output of a row-parallel product, the experts' combine);
- `split_along(x, dim, group)`: this rank's slice forward, all-gather of
  the gradient backward (a replicated tensor entering a sharded region);
- `gather_along(x, dim, group)`: all-gather forward, this rank's slice of
  the gradient backward (a sharded result leaving it);
- `all_to_all_along(x, split_dim, concat_dim, group)`: one all-to-all,
  backward the inverse one (Ulysses attention);
- `gather_batch(x, group)`: all-gather of the batch axis forward,
  reduce-scatter (sum) of the gradient backward (a batch statistic over
  `data` x `fsdp`);
- `all_reduce_sum(x, group)`: all-reduce forward and backward (the same,
  for a sum that every rank adds to its loss).

A group of one (or `None`) makes every function the identity. Only the
collectives of both the CUDA and the CPU builds of PyTorch are used:
`all_reduce`, `all_gather_into_tensor`, `reduce_scatter_tensor`,
`all_to_all_single`, `broadcast` and `batch_isend_irecv`."""

from typing import Any, List, Optional

import torch
import torch.distributed as dist


def group_size(group: Optional[Any]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather0(x: torch.Tensor, group: Any) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_along(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The ranks' tensors concatenated along `dim`, in rank order (no graph)."""
    if group_size(group) == 1:
        return x
    return _all_gather0(x.movedim(dim, 0), group).movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over {n} ranks")
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return _all_reduce(g, ctx.group), None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):  # type: ignore[override]
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return all_gather_along(g, ctx.dim, ctx.group), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):  # type: ignore[override]
        ctx.dim, ctx.group = dim, group
        return all_gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return _slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        ctx.group = group
        return _all_gather0(x, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        g = g.contiguous()
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group: Any) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does not divide over {n} ranks")
    # chunk i of split_dim goes to rank i; what rank j sends lands as chunk j of concat_dim
    parts = x.movedim(split_dim, 0)
    parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:])).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    # out: (n, chunk, ...) with the split dim at 1; move the rank axis next to concat_dim and merge
    out = out.movedim(1, split_dim + 1)  # (n, ...original order...)
    out = out.movedim(0, concat_dim)
    shape = list(out.shape)
    merged = shape[:concat_dim] + [shape[concat_dim] * shape[concat_dim + 1]] + shape[concat_dim + 2:]
    return out.reshape(merged)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):  # type: ignore[override]
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def split_along(x: torch.Tensor, dim: int, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _SplitAlong.apply(x, dim % x.ndim, group)


def gather_along(x: torch.Tensor, dim: int, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherAlong.apply(x, dim % x.ndim, group)


def gather_batch(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherBatch.apply(x, group)


def all_to_all_along(x: torch.Tensor, split_dim: int, concat_dim: int, group: Optional[Any]) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim % x.ndim, concat_dim % x.ndim, group)


@torch.no_grad()
def all_reduce_(tensors: List[torch.Tensor], group: Optional[Any], *, average: bool = False) -> None:
    """Sum (or average) `tensors` in place over `group`, flattened into one
    buffer per dtype so that a step makes one collective per dtype."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if average:
            flat.div_(n)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
