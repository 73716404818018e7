"""Training step: loss -> grads (with microbatch accumulation) -> AdamW
(port of ``repro.train.step``).

The state is a plain dict of tensors, ``{"params", "opt", "step"}``, in
the reference's layout (``opt`` = ``{"m", "v", "step"}``, the optimizer's
step f32, the state's int32), so it saves and restores through
``repro_torch.checkpoint`` and crosses to and from the reference by key
(``repro_torch.weights``).  The parameter leaves require grad; the
optimizer updates them, and the moments, in place under
``torch.no_grad()``.  Gradients come from ``torch.autograd.grad``, never
``.grad``, so nothing accumulates between steps.

Microbatches follow the reference's ``lax.scan`` exactly: the gradients
accumulate as ``gacc + g.to(acc_dt) / n_mb``, microbatch by microbatch, in
f32, or in bf16 for the ``moe`` family with ``microbatches > 1``
(``accum_dtype`` overrides both); the loss is the mean over microbatches.

**Data parallelism.**  Under an active sharding context
(``repro_torch.distributed.activate`` with a ``DeviceMesh``) each rank
runs the step on its own block of the global batch (its rows along the
batch axes) and holds its own shards of the parameters and moments
(``models.common.local_tree``): the expert leaves of MoE blocks split over
``model`` (and over ``expert_mlp``'s data axes, FSDP), every other leaf
whole.  Each rank differentiates its local mean loss; a leaf's gradient
is then summed over the batch axes it is not stored over and divided by
the batch axes' size, so every rank holds the gradient of the global
mean loss for its shard (an FSDP leaf's sum over its data axes came from
the reduce-scatter in the backward of its all-gather).  The clip norm
counts each shard once; AdamW updates the local shards in place.  The
reported loss is the mean over the batch axes.  Rules that split a dense
leaf over an axis larger than one raise ``NotImplementedError``: tensor
parallelism of the dense layers is ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.context import active_ctx
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.models.transformer import lm_loss, model_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_apply, adamw_init
from repro_torch.weights import unflatten

__all__ = ["TrainState", "init_train_state", "make_train_step"]

TrainState = dict  # {"params": ..., "opt": ..., "step": int32}


def init_train_state(params: Any, opt_cfg: AdamWConfig) -> TrainState:
    """Zero optimizer state and step beside ``params``, whose leaves are
    made to require grad (in place: the state holds the same tensors)."""
    params = tree_map(lambda t: t.requires_grad_(True), params)
    dev = tree_leaves(params)[0][1].device
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_microbatches(batch: dict, n: int) -> dict:
    """Every leaf ``[B, ...]`` -> ``[n, B // n, ...]``."""
    def split(x):
        B = x.shape[0]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum_dtype: Optional[str] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    (``loss``, ``grad_norm``, ``lr``) are 0-d f32 tensors on the device."""
    n_mb = max(cfg.microbatches, 1)
    acc_dt = getattr(torch, accum_dtype) if accum_dtype else (
        torch.bfloat16 if cfg.family == "moe" and cfg.microbatches > 1
        else torch.float32)

    def value_and_grad(keys, leaves, batch):
        loss = lm_loss(unflatten(dict(zip(keys, leaves))), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def grads_of(params, batch):
        keys, leaves = zip(*tree_leaves(params))
        if n_mb == 1:
            loss, grads = value_and_grad(keys, leaves, batch)
        else:
            mb = _split_microbatches(batch, n_mb)
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in leaves]
            for i in range(n_mb):
                l, g = value_and_grad(keys, leaves,
                                      {k: v[i] for k, v in mb.items()})
                grads = [a + b.to(acc_dt) / n_mb for a, b in zip(grads, g)]
                loss = loss + l / n_mb
        return loss, unflatten(dict(zip(keys, grads)))

    # the data-parallel layout of the last (ctx, params) seen: one per
    # activate block and state, not one per step (weakly held: a step
    # function keeps neither alive)
    last: dict = {}

    def layout_of(ctx, params):
        if last.get("ctx", lambda: None)() is not ctx or \
                last.get("params") != id(params):
            last.update(ctx=weakref.ref(ctx), params=id(params),
                        layout=_dp_layout(ctx, cfg, params))
        return last["layout"]

    def train_step(state: TrainState, batch: dict):
        ctx = active_ctx()
        layout = None if ctx is None else layout_of(ctx, state["params"])
        loss, grads = grads_of(state["params"], batch)
        norm_groups = None
        if ctx is not None:
            loss, norm_groups = _data_parallel(ctx, layout, loss, grads)
        params, opt, om = adamw_apply(grads, state["opt"], state["params"],
                                      opt_cfg, norm_groups=norm_groups)
        metrics = {"loss": loss, **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def _dp_layout(ctx, cfg: ModelConfig, params: Any) -> dict:
    """Per leaf key: (the group its gradient is summed over, the group
    holding its other shards or ``None``).  Raises before any work where
    the rules split a leaf the step cannot hold, or a parameter is not this
    rank's shard."""
    mesh = ctx.mesh
    size = mesh.shape
    batch = ctx.batch_axes()
    flat_p = dict(tree_leaves(params))
    layout = {}
    for key, s in tree_leaves(model_specs(cfg)):
        spec = ctx.spec(s.logical, s.shape)
        split = [tuple(a for a in ((e,) if isinstance(e, str) else e or ())
                       if size[a] > 1) for e in spec]
        split += [()] * (len(s.shape) - len(split))
        if split != ctx.expert_split(s.logical):
            raise NotImplementedError(
                f"{key}: the rules split it as {spec} over {mesh.shape}; the "
                f"data-parallel step keeps dense leaves whole and splits "
                f"expert leaves over 'model' and expert_mlp's axes only "
                f"(tensor parallelism of the dense layers: ROADMAP Queue 1 "
                f"item 2)")
        local = tuple(sl.stop - sl.start for sl in mesh.local_slices(
            spec, s.shape, {a: 0 for a in mesh.axis_names}))
        if tuple(flat_p[key].shape) != local:
            raise ValueError(
                f"{key}: this rank holds {tuple(flat_p[key].shape)}, its "
                f"shard is {local} (models.common.local_tree of "
                f"distribute_tree(params, sharding_tree(specs)))")
        stored = {a for part in split for a in part}
        layout[key] = (mesh.group(tuple(a for a in batch if a not in stored)),
                       mesh.group(tuple(stored)) if stored else None)
    return layout


def _data_parallel(ctx, layout: dict, loss: torch.Tensor,
                   grads: Any) -> tuple[torch.Tensor, dict]:
    """Reduce this rank's gradients in place to the global mean loss's;
    returns the mean loss over the batch axes and the clip norm's groups."""
    n_data = math.prod(ctx.axis_size(a) for a in ctx.batch_axes())
    flat_g = dict(tree_leaves(grads))
    norm_groups = {}
    for key, (group, shards) in layout.items():
        g = flat_g[key]
        # a collective takes contiguous memory; a gradient may be a
        # transposed layout (the tied embedding's on the card)
        buf = g if g.is_contiguous() else g.contiguous()
        if group is not None:
            dist.all_reduce(buf, group=group)
        buf.div_(n_data)
        if buf is not g:
            g.copy_(buf)
        if shards is not None:
            norm_groups[key] = shards
    loss = loss.clone()
    group = ctx.mesh.group(ctx.batch_axes())
    if group is not None:
        dist.all_reduce(loss, group=group)
    return loss / n_data, norm_groups
