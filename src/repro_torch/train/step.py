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
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.models.transformer import lm_loss
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

    def train_step(state: TrainState, batch: dict):
        loss, grads = grads_of(state["params"], batch)
        params, opt, om = adamw_apply(grads, state["opt"], state["params"],
                                      opt_cfg)
        metrics = {"loss": loss, **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step
