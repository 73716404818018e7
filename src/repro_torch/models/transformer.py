"""Decoder assembly and the one-token decode step (port of the dense path
of ``repro.models.transformer``).

The parameter tree keeps the reference's layout: layers stacked on a
leading axis under ``blocks/b0_attn``, so ``wq`` is ``[L, d, H, hd]`` and
a checkpoint crosses between the packages by key.  The reference's
``lax.scan`` over the stack is a Python loop over the leading axis here.

Ported: the dense program (``("attn",) * L``), its specs, the KV cache
and ``decode_step``.  The other families, the full-sequence ``forward``
and ``prefill`` come with their slices.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.common import (ModelConfig, ParamSpec, init_params,
                                       spec_tree_num_params, tree_map)
from repro_torch.models.layers import (apply_norm, attention_from_cache,
                                       attention_specs, mlp, mlp_specs,
                                       norm_spec)

__all__ = ["program_for", "model_specs", "cache_specs", "init_cache",
           "decode_step", "num_params", "Decoder"]


# ------------------------------------------------------------------ programs

def program_for(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """(group_def, n_groups, remainder_def) for the decoder stack."""
    if cfg.family != "dense" or cfg.local_global_pattern:
        raise NotImplementedError(
            f"{cfg.name}: only the dense global-attention program is ported")
    if cfg.norm_mult_dtype != "float32":
        raise NotImplementedError("norm_mult_dtype='compute' is not ported")
    return ("attn",), cfg.n_layers, ()


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind != "attn":
        raise NotImplementedError(kind)
    return {"ln1": norm_spec(cfg), "attn": attention_specs(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_specs(cfg)}


def _stack(specs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every ParamSpec in the tree."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical),
                                        s.init, s.scale), specs)


def model_specs(cfg: ModelConfig) -> dict:
    grp, n_groups, rem = program_for(cfg)
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), "normal",
                           1.0 / math.sqrt(d)),
        "final_norm": norm_spec(cfg),
        "blocks": _stack({f"b{i}_{k}": _block_specs(cfg, k)
                          for i, k in enumerate(grp)}, n_groups),
        "tail": {f"t{i}_{k}": _block_specs(cfg, k) for i, k in enumerate(rem)},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                                     "normal", 1.0 / math.sqrt(d))
    return specs


def num_params(cfg: ModelConfig) -> int:
    return spec_tree_num_params(model_specs(cfg))


# ------------------------------------------------------------------- decode

def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    grp, n_groups, rem = program_for(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd

    def kv():
        return {n: ParamSpec((batch, s_max, KV, hd),
                             ("batch", "cache_seq", "kv_heads", "head_dim"),
                             "zeros") for n in ("k", "v")}

    return {"blocks": _stack({f"b{i}_{k}": kv() for i, k in enumerate(grp)},
                             n_groups),
            "tail": {f"t{i}_{k}": kv() for i, k in enumerate(rem)}}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: Union[str, torch.device]) -> dict:
    """Zeroed KV cache tree in the compute dtype, on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=cfg.torch_dtype,
                                          device=device),
                    cache_specs(cfg, batch, s_max))


def _decode_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  cache: dict, pos: torch.Tensor, *, plain: bool) -> torch.Tensor:
    """One attention block; writes this layer's cache in place."""
    eps, nk = cfg.norm_eps, cfg.norm
    h = apply_norm(p["ln1"], x, eps, nk, plain=plain)
    y, _, _ = attention_from_cache(p["attn"], cfg, h, cache["k"], cache["v"],
                                   pos, plain=plain)
    x = x + y
    h = apply_norm(p["ln2"], x, eps, nk, plain=plain)
    return x + mlp(p["mlp"], cfg, h)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                plain: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step.  token ``[B, 1]`` int, pos an int32 scalar tensor
    on the parameters' device.  Returns ``(logits [B, V], cache)``; the
    cache is updated in place (the reference returns a new one).

    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    on-card reference the kernels are held against)."""
    x = params["embed"][token].to(cfg.torch_dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.torch_dtype)
    grp, n_groups, rem = program_for(cfg)
    blocks, caches = params["blocks"], cache["blocks"]
    for layer in range(n_groups):
        for i, kind in enumerate(grp):
            key = f"b{i}_{kind}"
            p = tree_map(lambda t: t[layer], blocks[key])
            c = tree_map(lambda t: t[layer], caches[key])
            x = _decode_block(cfg, kind, p, x, c, pos, plain=plain)
    for i, kind in enumerate(rem):
        key = f"t{i}_{kind}"
        x = _decode_block(cfg, kind, params["tail"][key], x,
                          cache["tail"][key], pos, plain=plain)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.norm,
                   plain=plain)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    return logits[:, 0], cache


# -------------------------------------------------------------------- module

class _ParamTree(nn.Module):
    """Registers a nested dict of tensors as parameters and submodules, so
    ``state_dict`` keys are the reference's key paths with "." for "/"."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out: dict = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out


class Decoder(nn.Module):
    """The decoder of one config, holding its parameter tree.

    ``Decoder(cfg)`` draws random weights on the card (seeded from
    ``generator``, or seed 0); ``Decoder(cfg, params=tree)`` wraps a tree
    that already holds the weights (a restored checkpoint).  ``device``
    defaults to ``"cuda"`` and raises without a card."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(model_specs(cfg), generator,
                                 cfg.torch_dtype, dev)
        else:
            params = tree_map(lambda t: t.to(dev), params)
        self.params = _ParamTree(params)

    def tree(self) -> dict:
        """The parameter tree (nested dict of tensors, reference layout)."""
        return self.params.tree()

    @torch.inference_mode()
    def forward(self, cache: dict, token: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        return decode_step(self.tree(), self.cfg, cache, token, pos)
