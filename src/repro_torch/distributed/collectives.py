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

- :func:`share_grad` and :func:`sum_partials`, the one-hot MoE path's
  pair around the expert shards on a mesh (``models.moe``): the first is
  the identity forward and, backward, the gradient summed over the
  shards' group and divided by ``parts`` (the ranks of that group whose
  losses differ, each of which then holds its share); the second sums
  the shards' partial outputs forward and, backward, sums the gradient
  over ``grad_group`` only (the ranks of the group with other batch rows:
  ranks that differ only along ``model`` hold the same loss, which must
  count once).  :func:`copy_to_model` is the first with one part,
  :func:`reduce_from_model` and :func:`shared_sum` the second with no
  ``grad_group`` and with ``group`` itself.

A group of one rank makes each an identity that still issues its
collective.  :func:`gather_dim` is also the one-hot MoE path's row
gather over the batch axes: every rank routes the global tokens, and the
reduce-scatter hands each rank the summed gradient of its own rows.

**Member order.**  A group over several mesh axes
(``distributed.context.Mesh.group``) orders its members as the caller
named the axes, the first named major, as JAX orders the devices of
``P(("data", "pod"))``.  ``torch.distributed.new_group`` always ranks
its members in global-rank order, which is the mesh's order of the axes;
where the two differ, :func:`set_member_order` records each named
position's group rank, and every collective here that places blocks
(the gathers, the reduce-scatter, :func:`split`, :func:`all_to_all`)
puts block ``i`` at named position ``i``.  :func:`group_rank` is this
rank's named position.  All-reduces need no order.

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
           "copy_to_model", "reduce_from_model", "shared_sum", "share_grad",
           "sum_partials", "set_member_order", "group_rank"]

#: process group -> (the group rank at each named position, the named
#: position of each group rank), for the groups whose members were named
#: out of global-rank order (:func:`set_member_order`)
_ORDER: dict = {}


def set_member_order(group, ranks) -> None:
    """Record that ``group``'s members, named in the order of their axes
    (first named major), are the global ``ranks`` in this order."""
    ranks = [int(r) for r in ranks]
    by_rank = sorted(ranks)
    if ranks == by_rank:
        _ORDER.pop(group, None)
        return
    at = [by_rank.index(r) for r in ranks]
    named = [ranks.index(r) for r in by_rank]
    _ORDER[group] = (torch.tensor(at), torch.tensor(named))


def group_rank(group) -> int:
    """This rank's position among ``group``'s members in the order their
    axes were named (its group rank where they were named in mesh
    order)."""
    r = dist.get_rank(group)
    order = _ORDER.get(group)
    return r if order is None else int(order[1][r])


def _to_named(x: torch.Tensor, group) -> torch.Tensor:
    """Blocks of dim 0 in group-rank order -> in named order."""
    order = _ORDER.get(group)
    if order is None:
        return x
    n = order[0].numel()
    blocks = x.view(n, x.shape[0] // n, *x.shape[1:])
    return blocks.index_select(0, order[0].to(x.device)).view(x.shape)


def _to_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """Blocks of dim 0 in named order -> in group-rank order."""
    order = _ORDER.get(group)
    if order is None:
        return x
    n = order[1].numel()
    blocks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return blocks.index_select(0, order[1].to(x.device)).view(x.shape)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Every rank's ``x`` stacked along dim 0 into ``out``, in named
    order."""
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if group in _ORDER:
        out.copy_(_to_named(out, group))


def all_gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (at least 1-d) stacked on a new leading dim, in
    group-rank order (no autograd)."""
    return _gather0(x, group).view(-1, *x.shape)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group-rank order
    (no autograd)."""
    return _gather_at(x, group, dim)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = _to_ranks(x.contiguous(), group).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return _to_named(out, group)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    all_gather_into(out, x, group)
    return out


def _block0(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), group_rank(group)
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
        gt = _to_ranks(g.transpose(0, ctx.dim).contiguous(), ctx.group)
        out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt.contiguous(), group=ctx.group)
        return out.transpose(0, ctx.dim), None, None


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, parts):
        ctx.group, ctx.parts = group, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        if ctx.parts != 1:
            out.div_(ctx.parts)
        return out, None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_group):
        ctx.grad_group = grad_group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_group is None:
            return g, None, None
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.grad_group)
        return out, None, None


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
    shards, or the one-hot MoE path's token rows); the gradient is summed
    over ``group`` and each rank keeps its block."""
    return _GatherDim.apply(w, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (the entry of a
    column-parallel region)."""
    return _ShareGrad.apply(x, group, 1)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; the gradient passes
    through (the exit of a row-parallel region)."""
    return _SumPartials.apply(x, group, None)


def shared_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, which every rank's
    output reads; its gradient is summed over ``group`` too."""
    return _SumPartials.apply(x, group, group)


def share_grad(x: torch.Tensor, group, parts: int = 1) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` and divided by
    ``parts``."""
    return _ShareGrad.apply(x, group, parts)


def sum_partials(x: torch.Tensor, group, grad_group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; its gradient is
    summed over ``grad_group`` (passed through where it is ``None``)."""
    return _SumPartials.apply(x, group, grad_group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``; its backward passes the gradient
    through unscaled."""
    return _AllMean.apply(x, group)
