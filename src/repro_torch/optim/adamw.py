"""AdamW with dtype-configurable moments (port of ``repro.optim.adamw``).

The reference's math, op for op: f32 master math on the (bf16) parameters
(``_upd_f32``), moments stored in ``moment_dtype``, the global-norm clip,
bias correction from the f32 ``step``, and no weight decay on 1-D leaves
(norm scales, biases).  ``torch.optim.AdamW`` keeps other state and rounds
elsewhere, so it is not used.

**ZeRO-1** (``AdamWConfig.zero1``, the reference's flag): under an
active sharding context the moments may be split further than the
parameters, over the data axes on their ``d`` dims, as
``launch.dryrun.opt_rules_for`` resolves them (:func:`zero1_layout`).
Each rank then updates only the block of its parameter block that its
moments cover, and all-gathers the updated blocks over those axes.  The
gradient is reduced as without ZeRO-1 (an all-reduce, not ZeRO-2's
reduce-scatter), so a ZeRO-1 step is bit-equal to the same mesh's step
without it: the update is elementwise.

Unlike the reference, which returns new trees, :func:`adamw_apply`
updates the parameters and both moments IN PLACE (the f32 temporaries of
one block of at most ``UPDATE_BLOCK`` elements of one leaf at a time), so
a step never holds a second copy of the model or of its moments.  Every
quantity stays on the device: the step, learning rate, norm and clip scale
are 0-d f32 tensors, so a step never waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import ShardingCtx, ShardingRules
from repro_torch.models.common import ParamSpec, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_apply", "opt_state_specs",
           "lr_at_step", "global_norm", "zero1_layout"]

#: elements of a leaf updated at a time (each f32 temporary of the update
#: is at most this large: 256 MiB)
UPDATE_BLOCK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"      # bf16 halves optimizer memory (kimi)
    # shard the moments over the data axes (ZeRO-1: read by
    # train.step.init_sharded_train_state under an active context)
    zero1: bool = True


def lr_at_step(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``, on the step's
    device (an f32 0-d tensor; no host sync)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def opt_state_specs(param_specs: Any, cfg: AdamWConfig) -> Any:
    """ParamSpec tree for (m, v, step): the parameters' shapes."""
    mk = lambda s: ParamSpec(s.shape, s.logical, "zeros")  # noqa: E731
    return {"m": tree_map(mk, param_specs), "v": tree_map(mk, param_specs),
            "step": ParamSpec((), (), "zeros")}


def zero1_layout(ctx, param_specs: Any, opt_rules: ShardingRules) -> dict:
    """Per "/"-key of a leaf whose moments ``opt_rules`` split further than
    the active rules split the parameter: (the moment block's slices
    within this rank's parameter block, the group over the added axes,
    every member's slices in the group's order).  Raises
    ``NotImplementedError`` where a moment would not be a block of its
    parameter's block."""
    mesh = ctx.mesh
    octx = ShardingCtx(mesh, opt_rules)
    out = {}
    for key, s in tree_leaves(param_specs):
        pl, ml = ctx.layout(s.logical, s.shape), octx.layout(s.logical,
                                                             s.shape)
        if any(a not in m for p, m in zip(pl, ml) for a in p):
            raise NotImplementedError(
                f"{key}: its moments ({ml}) are not a block of the "
                f"parameter's block ({pl})")
        # the added axes in the moments' spec order (the first named
        # major: ``("data", "pod")`` under the multi-pod rules), the order
        # of the group's members and of their slices
        axes = tuple(a for p, m in zip(pl, ml) for a in m if a not in p)
        if not axes:
            continue
        pspec = ctx.spec(s.logical, s.shape)
        mspec = octx.spec(s.logical, s.shape)
        base = mesh.local_slices(pspec, s.shape)
        members = [tuple(slice(m.start - b.start, m.stop - b.start)
                         for m, b in zip(mesh.local_slices(mspec, s.shape, c),
                                         base))
                   for c in mesh.member_coords(axes)]
        mine = tuple(slice(m.start - b.start, m.stop - b.start)
                     for m, b in zip(mesh.local_slices(mspec, s.shape),
                                     base))
        out[key] = (mine, mesh.group(axes), members)
    return out


def adamw_init(params: Any, cfg: AdamWConfig,
               blocks: Optional[dict] = None) -> dict:
    """Zero moments in ``moment_dtype`` and an f32 step of 0, each on its
    parameter's device.  ``blocks`` ("/"-key -> slices, as
    :func:`zero1_layout`'s first entry): those leaves' moments cover only
    that block of the parameter (ZeRO-1)."""
    dt = getattr(torch, cfg.moment_dtype)
    blocks = blocks or {}

    def zeros(key, p):
        shape = (tuple(sl.stop - sl.start for sl in blocks[key])
                 if key in blocks else p.shape)
        return torch.zeros(shape, dtype=dt, device=p.device)

    def keyed(node, prefix=""):
        if isinstance(node, dict):
            return {k: keyed(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        return zeros(prefix, node)

    dev = tree_leaves(params)[0][1].device
    return {"m": keyed(params), "v": keyed(params),
            "step": torch.zeros((), dtype=torch.float32, device=dev)}


def global_norm(tree: Any, groups: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, leaves in the
    reference's (sorted key) order.

    ``groups`` ("/"-key -> process group) names the leaves that are this
    rank's shards of a larger leaf: their sums of squares are all-reduced
    over the group that holds the other shards (every shard counted once,
    one all-reduce per group) before they join the rest."""
    groups = groups or {}
    sq = [(k, torch.sum(torch.square(g.float()))) for k, g in tree_leaves(tree)]
    total = sum(s for k, s in sq if k not in groups)
    shards: dict = {}
    for k, s in sq:
        if k in groups:
            shards.setdefault(groups[k], []).append(s)
    for group, parts in shards.items():
        part = sum(parts)
        dist.all_reduce(part, group=group)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_apply(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                decay_mask: Optional[Any] = None, *,
                norm_groups: Optional[dict] = None,
                zero1: Optional[dict] = None):
    """Returns ``(params, state, metrics)``.  ``params`` and the moments
    are updated in place (the reference returns new trees); ``state`` is a
    new dict holding the same moment tensors and the new f32 step.
    metrics: ``grad_norm`` and ``lr``, 0-d f32 tensors.  ``norm_groups``
    as for :func:`global_norm` (sharded leaves of a data-parallel step).
    ``zero1`` (:func:`zero1_layout`): the leaves whose moments are a block
    of the parameter; that block is updated and all-gathered over the
    group, every member's block copied into the parameter."""
    step = state["step"] + 1.0
    lr = lr_at_step(cfg, step)
    gnorm = global_norm(grads, norm_groups)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v, wd):
        # the reference's _upd_f32, op for op
        gf = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + wd * pf)
        p.copy_(pf.to(p.dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))

    # weight decay skips 1-D params (norm scales, biases) by default
    if decay_mask is None:
        decay_mask = tree_map(
            lambda p: cfg.weight_decay if p.dim() >= 2 else 0.0, params)
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state["m"]))
    flat_v = dict(tree_leaves(state["v"]))
    flat_w = dict(tree_leaves(decay_mask))
    zero1 = zero1 or {}
    for key, p in tree_leaves(params):
        g, m, v, wd = flat_g[key], flat_m[key], flat_v[key], flat_w[key]
        z = zero1.get(key) if m.shape != p.shape else None
        whole = p
        if z is not None:
            # this rank's block of the parameter, updated apart
            p = p[z[0]].clone(memory_format=torch.contiguous_format)
            g = g[z[0]]
        # elementwise, so block by block gives the same values; a stacked
        # expert leaf of a billion elements would otherwise hold six f32
        # copies of itself at once
        flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
        for i in range(0, p.numel(), UPDATE_BLOCK):
            upd(*(t[i:i + UPDATE_BLOCK] for t in flat), wd)
        if z is not None:
            _, group, members = z
            got = C.all_gather_stacked(p, group)
            for sl, blk in zip(members, got):
                whole[sl].copy_(blk)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
