"""Collectives with a stated backward, for model code that runs one rank's
share of a sharded computation (the expert-parallel MoE block, the
tensor-parallel attention, MLP, embedding and logits, and the FSDP
gathers of stored weights).

JAX differentiates through ``shard_map`` collectives by their transposes.
Here each collective is an ``autograd.Function`` whose backward is chosen
so that every leaf replicated over the ``model`` axis gets its full
gradient on every model rank, with no model-axis all-reduce afterwards:

- :func:`all_to_all`: forward an all-to-all of equal blocks along dim 0,
  backward the same all-to-all of the gradient (its transpose);
- :func:`split`: forward this rank's block of a tensor replicated over the
  group, backward an all-gather (every rank's block of the gradient);
- :func:`gather`: forward an all-gather of each rank's block, backward
  this rank's block of the gradient (the computation after it is
  replicated, so every rank holds the same full gradient: ``torch.
  distributed.nn``'s all-gather would sum the copies);
- :func:`gather_dim`: the FSDP gather of a stored weight along one dim
  (an expert leaf's dim 1, a dense leaf's ``d`` dim), backward a
  reduce-scatter (sum) of the gradient: every rank used the whole weight
  on its own rows of the batch;
- :func:`copy_to_model` and :func:`reduce_from_model`, Megatron's
  conjugate pair around a tensor-parallel region: the first is the
  identity forward and an all-reduce (sum) of the gradient backward, at
  the entry of a column-parallel product (each rank's local heads or MLP
  columns give a part of the input's gradient); the second an all-reduce
  (sum) forward and the identity backward, at the exit of a row-parallel
  product (each rank's local heads give a part of the output);
- :func:`all_mean`: forward the group mean, backward the identity, so the
  data-parallel mean of per-rank gradients of a function of the global
  mean is that function's gradient;
- :func:`shared_sum`: forward an all-reduce (sum), backward an all-reduce
  (sum) too: a statistic summed over ranks that every rank's output then
  reads (the Mamba2 gated norm's sum of squares over ``d_inner`` cut over
  ``model``), whose gradient gathers every rank's use of it.

A group of one rank makes each an identity that still issues its
collective.

Forward-only, for the decode step (which raises under grad):
:func:`all_gather_stacked` gathers the ranks' attention partials over a
cache's sequence group, :func:`all_gather_cat` the logits' vocabulary
blocks over ``model`` and the batch rows over the batch axes, for
sampling.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "split", "gather", "gather_dim", "all_mean",
           "all_gather_cat", "all_gather_into", "all_gather_stacked",
           "copy_to_model", "reduce_from_model", "shared_sum"]


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Every rank's ``x`` stacked along dim 0 into ``out``."""
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)


def all_gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (at least 1-d) stacked on a new leading dim, in
    group-rank order (no autograd)."""
    return _gather0(x, group).view(-1, *x.shape)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group-rank order
    (no autograd)."""
    return _gather_at(x, group, dim)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    all_gather_into(out, x, group)
    return out


def _block0(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    step = x.shape[0] // n
    return x[r * step:(r + 1) * step].contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _gather_at(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``."""
    return _gather0(x.transpose(0, dim), group).transpose(0, dim)


def _block_at(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _block0(x.transpose(0, dim), group).transpose(0, dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g.contiguous(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_at(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block_at(g, ctx.group, ctx.dim), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_at(w, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gt = g.transpose(0, ctx.dim).contiguous()
        out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.transpose(0, ctx.dim), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to group rank ``j``; block ``j`` of the
    result came from rank ``j``."""
    return _AllToAll.apply(x, group)


def split(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of dim 0 of ``x`` (replicated over ``group``)."""
    return _Split.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group-rank order;
    the computation after it is replicated over ``group``."""
    return _Gather.apply(x, group, dim)


def gather_dim(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``w`` concatenated along ``dim`` (FSDP storage
    shards); the gradient is summed over ``group`` and each rank keeps its
    block."""
    return _GatherDim.apply(w, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (the entry of a
    column-parallel region)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; the gradient passes
    through (the exit of a row-parallel region)."""
    return _ReduceFromModel.apply(x, group)


def shared_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, which every rank's
    output reads; its gradient is summed over ``group`` too."""
    return _SharedSum.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``; its backward passes the gradient
    through unscaled."""
    return _AllMean.apply(x, group)
