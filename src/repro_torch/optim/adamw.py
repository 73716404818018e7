"""AdamW with dtype-configurable moments (port of ``repro.optim.adamw``).

The reference's math, op for op: f32 master math on the (bf16) parameters
(``_upd_f32``), moments stored in ``moment_dtype``, the global-norm clip,
bias correction from the f32 ``step``, and no weight decay on 1-D leaves
(norm scales, biases).  ``torch.optim.AdamW`` keeps other state and rounds
elsewhere, so it is not used.

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

from repro_torch.models.common import ParamSpec, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_apply", "opt_state_specs",
           "lr_at_step", "global_norm"]

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
    # the reference shards the moments over its data axes (ZeRO-1); the
    # port keeps them beside the parameters' shards (not read yet)
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


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` and an f32 step of 0, each on its
    parameter's device."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0][1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
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
                norm_groups: Optional[dict] = None):
    """Returns ``(params, state, metrics)``.  ``params`` and the moments
    are updated in place (the reference returns new trees); ``state`` is a
    new dict holding the same moment tensors and the new f32 step.
    metrics: ``grad_norm`` and ``lr``, 0-d f32 tensors.  ``norm_groups``
    as for :func:`global_norm` (sharded leaves of a data-parallel step)."""
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
    for key, p in tree_leaves(params):
        g, m, v, wd = flat_g[key], flat_m[key], flat_v[key], flat_w[key]
        # elementwise, so block by block gives the same values; a stacked
        # expert leaf of a billion elements would otherwise hold six f32
        # copies of itself at once
        flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
        for i in range(0, p.numel(), UPDATE_BLOCK):
            upd(*(t[i:i + UPDATE_BLOCK] for t in flat), wd)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
