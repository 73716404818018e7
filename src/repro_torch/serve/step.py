"""Serving steps: full-sequence prefill, and batched one-token decode
against the cache followed by greedy or temperature sampling on the device
(port of ``repro.serve.step``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import decode_step, forward

__all__ = ["make_serve_step", "make_prefill_step"]


def make_prefill_step(cfg: ModelConfig, *, plain: bool = False):
    """prefill_step(params, batch) -> last-position logits ``[B, V]`` f32.

    ``plain=True`` runs the plain PyTorch versions of the kernels."""

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = forward(params, cfg, batch, plain=plain)
        return logits[:, -1].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    """serve_step(params, cache, token, pos, generator=None) ->
    (next_token [B, 1], logits [B, V] f32, cache)."""

    def serve_step(params: dict, cache: dict, token: torch.Tensor,
                   pos: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        logits, cache = decode_step(params, cfg, cache, token, pos)
        logits = logits.float()
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)
        else:
            next_tok = torch.argmax(logits, dim=-1, keepdim=True)
        return next_tok, logits, cache

    return serve_step
