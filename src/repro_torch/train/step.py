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

**Distribution.**  Under an active sharding context
(``repro_torch.distributed.activate`` with a ``DeviceMesh`` and the
storage rules, e.g. ``launch.dryrun.rules_for(cfg, ...)[1]``) each rank
runs the step on its own block of the global batch (its rows along the
batch axes) and holds its own blocks of the parameters and moments
(``models.common.local_tree``; :func:`init_sharded_train_state`):

- a dense leaf split over ``model`` on its heads, MLP or vocabulary dim
  is tensor-parallel (``models.layers``, ``models.transformer``): the
  rank computes with its block;
- a dense leaf's ``d`` dims stored over data axes (FSDP: ``embed``,
  ``attn_in``, ``attn_out_d``) are gathered before use, and the backward
  reduce-scatters their gradient;
- expert leaves split over ``model`` (expert parallelism) and over
  ``expert_mlp``'s data axes (FSDP), as the MoE block says.

Each rank differentiates its local mean loss.  A leaf's gradient is then
summed over the batch axes it is not stored over, plus ``model`` where
the leaf is whole over ``model`` but used inside a tensor-parallel region
on this rank's heads only (``wk`` / ``wv`` / ``bk`` / ``bv`` with
``kv_heads`` masked to replicated, ``q_norm`` / ``k_norm``; a Mamba2
block's ``A_log`` / ``D`` / ``dt_bias``, and ``w_in`` where it is whole,
``models.ssm.mamba_partial_leaves``), and divided
by the batch axes' size, so every rank holds the gradient of the global
mean loss for its block (an FSDP leaf's sum over its data axes came from
the reduce-scatter).  The clip norm counts each element once; AdamW
updates the local blocks in place, and with ZeRO-1 moments
(``AdamWConfig.zero1``, moments split as ``launch.dryrun.opt_rules_for``
says) only the moments' block of each, all-gathered after.  The reported
loss is the mean over the batch axes.

Every family trains under these rules: the encdec and vlm families'
cross-attention on a rank's heads, their encoder and ``frontend_proj``
gathered where stored FSDP (``models.transformer``).  So do the multi-pod
production rules (``rules_for(cfg, multi_pod=True)`` on a ``(pod, data,
model)`` mesh): the batch spans ``("pod", "data")`` and the FSDP dims
and ZeRO-1 moments ``("data", "pod")``, data-major, which the groups and
gathers follow (``distributed.context.Mesh.group``).  Rules the step
cannot honour raise ``NotImplementedError`` before the first collective
(:func:`check_train_rules`): a ``seq_sp`` rule (sequence-parallel norm
segments), a ``layers`` rule (pipeline stages) and rules that split the
mLSTM's or sLSTM's heads wait for later slices (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.context import (FSDP_DIMS, TP_DIMS,
                                             ShardingCtx, active_ctx)
from repro_torch.launch.dryrun import opt_rules_for
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.models.ssm import check_heads, mamba_partial_leaves
from repro_torch.models.transformer import lm_loss, model_specs, program_for
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply, adamw_init,
                                     zero1_layout)
from repro_torch.weights import unflatten

__all__ = ["TrainState", "init_train_state", "init_sharded_train_state",
           "train_state_shardings", "check_train_rules", "make_train_step"]

TrainState = dict  # {"params": ..., "opt": ..., "step": int32}


def init_train_state(params: Any, opt_cfg: AdamWConfig) -> TrainState:
    """Zero optimizer state and step beside ``params``, whose leaves are
    made to require grad (in place: the state holds the same tensors)."""
    params = tree_map(lambda t: t.requires_grad_(True), params)
    dev = tree_leaves(params)[0][1].device
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _opt_ctx(ctx) -> ShardingCtx:
    """The moments' context: the mesh under ``opt_rules_for`` of the
    active (storage) rules."""
    return ShardingCtx(ctx.mesh, opt_rules_for(
        ctx.rules, "pod" in ctx.mesh.axis_names))


def _zero1(ctx, cfg: ModelConfig) -> dict:
    return zero1_layout(ctx, model_specs(cfg), _opt_ctx(ctx).rules)


def init_sharded_train_state(params: Any, cfg: ModelConfig,
                             opt_cfg: AdamWConfig) -> TrainState:
    """:func:`init_train_state` of this rank's parameter blocks under an
    active sharding context: with ``opt_cfg.zero1`` each moment is this
    rank's block under ``launch.dryrun.opt_rules_for`` of the active
    rules (split further over the data axes on its ``d`` dims), else the
    parameter block's shape."""
    ctx = active_ctx()
    if ctx is None:
        raise RuntimeError("init_sharded_train_state needs an active "
                           "sharding context")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    blocks = ({k: z[0] for k, z in _zero1(ctx, cfg).items()}
              if opt_cfg.zero1 else {})
    dev = tree_leaves(params)[0][1].device
    return {"params": params, "opt": adamw_init(params, opt_cfg, blocks),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_shardings(cfg: ModelConfig, state: TrainState) -> dict:
    """Each leaf's ``Placements`` in a state of local blocks under the
    active context (``save_checkpoint(shardings=)``,
    ``restore_checkpoint(shardings=)``): the parameters' from the active
    rules, each moment's from them or, where it is a ZeRO-1 block, from
    ``opt_rules_for``; the steps are whole (``None``)."""
    ctx = active_ctx()
    if ctx is None:
        raise RuntimeError("train_state_shardings needs an active sharding "
                           "context")
    octx = _opt_ctx(ctx)
    specs = dict(tree_leaves(model_specs(cfg)))
    flat_p = dict(tree_leaves(state["params"]))

    def of(c, key):
        return c.sharding(specs[key].logical, specs[key].shape)

    def moments(tree):
        return unflatten({k: of(ctx if m.shape == flat_p[k].shape else octx,
                                k) for k, m in tree_leaves(tree)})

    return {"params": unflatten({k: of(ctx, k) for k in flat_p}),
            "opt": {"m": moments(state["opt"]["m"]),
                    "v": moments(state["opt"]["v"]), "step": None},
            "step": None}


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

    # the layout of the last (ctx, state) seen: one per activate block
    # and state, not one per step (weakly held: a step function keeps
    # neither alive)
    last: dict = {}

    def layout_of(ctx, state):
        if last.get("ctx", lambda: None)() is not ctx or \
                last.get("params") != id(state["params"]):
            last.update(ctx=weakref.ref(ctx), params=id(state["params"]),
                        layout=_layout(ctx, cfg, opt_cfg, state))
        return last["layout"]

    def train_step(state: TrainState, batch: dict):
        ctx = active_ctx()
        layout = None if ctx is None else layout_of(ctx, state)
        loss, grads = grads_of(state["params"], batch)
        norm_groups = zero1 = None
        if ctx is not None:
            reduce, zero1 = layout
            loss, norm_groups = _reduce_grads(ctx, reduce, loss, grads)
        params, opt, om = adamw_apply(grads, state["opt"], state["params"],
                                      opt_cfg, norm_groups=norm_groups,
                                      zero1=zero1)
        metrics = {"loss": loss, **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def _where(key: str) -> str:
    return f"{key} (ROADMAP Queue 1 item 2)"


def check_train_rules(ctx, cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` where the active rules lay out a leaf
    of ``cfg`` as the step cannot hold it; runs no collective."""
    rules = ctx.rules.rules
    if rules.get("seq_sp") is not None:
        raise NotImplementedError(_where(
            f"{cfg.name}: a seq_sp rule ({rules['seq_sp']!r}): the "
            f"sequence-parallel norm segments (seq_shard_norms) are not "
            f"ported"))
    if rules.get("layers") is not None:
        raise NotImplementedError(_where(
            f"{cfg.name}: layers={rules['layers']!r}: pipeline stages "
            f"(distributed/pipeline.py, reference caveat b) are not "
            f"ported"))
    if ctx.axis_size("model") > 1 and "model" in ctx.batch_axes():
        raise NotImplementedError(_where(
            f"{cfg.name}: the batch split over 'model' and tensor "
            f"parallelism over it at once"))
    grp, _, rem = program_for(cfg)
    for kind in ("mlstm", "slstm"):
        if kind in grp + rem:
            check_heads(cfg, kind)
    flat = dict(tree_leaves(model_specs(cfg)))
    for key, s in flat.items():
        split = ctx.layout(s.logical, s.shape)
        if "expert" in s.logical:
            if split != ctx.expert_split(s.logical):
                raise NotImplementedError(_where(
                    f"{key}: the rules split it as {split}; an expert "
                    f"leaf splits over 'model' on its expert dim and over "
                    f"expert_mlp's axes on the next"))
            continue
        for name, axes in zip(s.logical, split):
            if not axes:
                continue
            if name in TP_DIMS and axes == ("model",):
                continue
            if name in FSDP_DIMS and "model" not in axes:
                continue
            raise NotImplementedError(_where(
                f"{key}: the rules split its {name!r} dim over {axes}; "
                f"the step splits heads, MLP columns and vocabulary over "
                f"'model' only, and stores d dims over data axes"))
        wk = flat.get(key[:-2] + "wk") if key.endswith("/wq") else None
        if wk is not None and "kv_heads" in wk.logical:
            q = ctx.layout(s.logical, s.shape)[s.logical.index("qheads")]
            kv = ctx.layout(wk.logical, wk.shape)[wk.logical.index(
                "kv_heads")]
            G = cfg.n_heads // cfg.n_kv_heads
            h_loc = cfg.n_heads // ctx.axis_size("model")
            if kv and not q:
                raise NotImplementedError(_where(
                    f"{key}: KV heads split over 'model' with the query "
                    f"heads whole"))
            if q and not kv and h_loc % G and G % h_loc:
                raise NotImplementedError(_where(
                    f"{key}: {h_loc} query heads a rank and {G} per KV "
                    f"head: a rank's heads would read a ragged KV group"))


def _partial_over_model(ctx, cfg: ModelConfig, flat: dict, key: str,
                        stored: set) -> bool:
    """Whether the leaf at ``key``, whole over ``model``, is used on this
    rank's heads only: a leaf of an attention (self or cross) whose query
    heads are split over ``model``, or of a Mamba2 block on its heads.
    The vlm ``xattn`` block's ``gate`` is not: it scales the
    cross-attention's output after the sum over ``model``, so every rank
    holds its whole gradient."""
    parent, _, name = key.rpartition("/")
    if "model" in stored:
        return False
    if parent.endswith("mamba"):
        return name in mamba_partial_leaves(cfg)
    wq = flat.get(parent + "/wq")
    if wq is None or "kv_heads" not in flat[parent + "/wk"].logical:
        return False
    q = ctx.layout(wq.logical, wq.shape)[wq.logical.index("qheads")]
    return "model" in q


def _layout(ctx, cfg: ModelConfig, opt_cfg: AdamWConfig,
            state: TrainState) -> tuple[dict, dict]:
    """(per leaf key: (the group its gradient is summed over, the group
    holding its other blocks or ``None``), the ZeRO-1 layout of the
    moments that are blocks of their parameter's block).  Raises before
    any collective where the rules lay out a leaf the step cannot hold,
    or a parameter or moment is not this rank's block."""
    check_train_rules(ctx, cfg)
    mesh = ctx.mesh
    batch = ctx.batch_axes()
    flat = dict(tree_leaves(model_specs(cfg)))
    flat_p = dict(tree_leaves(state["params"]))
    flat_m = dict(tree_leaves(state["opt"]["m"]))
    zero1 = _zero1(ctx, cfg) if opt_cfg.zero1 else {}
    reduce = {}
    for key, s in flat.items():
        spec = ctx.spec(s.logical, s.shape)
        local = tuple(sl.stop - sl.start for sl in mesh.local_slices(
            spec, s.shape, {a: 0 for a in mesh.axis_names}))
        if tuple(flat_p[key].shape) != local:
            raise ValueError(
                f"{key}: this rank holds {tuple(flat_p[key].shape)}, its "
                f"block is {local} (models.common.local_tree of "
                f"distribute_tree(params, sharding_tree(specs)))")
        m = tuple(flat_m[key].shape)
        if m != local and (key not in zero1 or m != tuple(
                sl.stop - sl.start for sl in zero1[key][0])):
            raise ValueError(
                f"{key}: its moments are {m}, neither the parameter's "
                f"block {local} nor its ZeRO-1 block "
                f"(init_sharded_train_state)")
        stored = {a for part in ctx.layout(s.logical, s.shape)
                  for a in part}
        axes = [a for a in batch if a not in stored]
        if _partial_over_model(ctx, cfg, flat, key, stored):
            axes.append("model")
        # all-reduces: any order of the axes, so the mesh's (one group
        # for every leaf over the same axes)
        reduce[key] = (mesh.group(mesh.in_order(axes)),
                       mesh.group(mesh.in_order(stored)) if stored else None)
    return reduce, zero1


def _reduce_grads(ctx, layout: dict, loss: torch.Tensor,
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
    group = ctx.mesh.group(ctx.mesh.in_order(ctx.batch_axes()))
    if group is not None:
        dist.all_reduce(loss, group=group)
    return loss / n_data, norm_groups
