"""Decoder assembly: the full-sequence forward and prefill, and the
one-token decode step (port of the dense and hybrid paths of
``repro.models.transformer``).

The parameter tree keeps the reference's layout: each group of the
program stacked on a leading axis under ``blocks/b<i>_<kind>`` (so a
dense ``wq`` is ``[L, d, H, hd]``), a ``tail`` for the remainder layers
and, for the hybrid family, one ``shared_attn`` block outside the stack,
so a checkpoint crosses between the packages by key.  The reference's
``lax.scan`` over the stack is a Python loop over the leading axis here.

Ported programs: dense global attention (``("attn",) * L``: qwen3,
qwen2.5, nemotron), the dense local/global program (``("attn_local",) * N
+ ("attn_global",)`` per group plus a local tail, gemma3; the local layers
attend within ``cfg.attn_window``) and the hybrid (``("mamba",) * period +
("shared_attn",)`` per group plus a mamba tail, zamba2).  The RoPE sin /
cos of the step's positions are computed once per forward or decode step
and shared by every layer.  ``forward`` builds no cache, as the reference's
does not; ``generate`` prefills through the decode step.  The training
levers ``remat`` and ``seq_shard_norms`` are not ported.  The other
families come with their slices.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.common import (ModelConfig, ParamSpec, init_params,
                                       spec_tree_num_params, tree_map)
from repro_torch.models.layers import (apply_norm, attention,
                                       attention_from_cache, attention_specs,
                                       mlp, mlp_specs, norm_spec,
                                       rope_sin_cos)

__all__ = ["program_for", "model_specs", "forward", "prefill", "cache_specs",
           "init_cache", "decode_step", "num_params", "Decoder"]


# ------------------------------------------------------------------ programs

def program_for(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """(group_def, n_groups, remainder_def) for the decoder stack."""
    if cfg.norm_mult_dtype != "float32":
        raise NotImplementedError("norm_mult_dtype='compute' is not ported")
    if cfg.norm_custom_bwd:
        # the reference's custom-VJP rmsnorm forward multiplies in the
        # compute dtype; it arrives with training
        raise NotImplementedError("norm_custom_bwd is not ported")
    L = cfg.n_layers
    if cfg.family == "hybrid":
        per = cfg.hybrid_period
        return ("mamba",) * per + ("shared_attn",), L // per, \
            ("mamba",) * (L % per)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense and hybrid programs are ported")
    if cfg.local_global_pattern:
        per = cfg.local_global_pattern + 1
        grp = ("attn_local",) * cfg.local_global_pattern + ("attn_global",)
        return grp, L // per, ("attn_local",) * (L % per)
    return ("attn",), L, ()


#: block kinds made of attention + MLP (``shared_attn`` uses the shared
#: parameters); ``attn_local`` attends within ``cfg.attn_window``
_ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn_window if kind == "attn_local" else None


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind in _ATTN_KINDS:
        return {"ln1": norm_spec(cfg), "attn": attention_specs(cfg),
                "ln2": norm_spec(cfg), "mlp": mlp_specs(cfg)}
    if kind == "mamba":
        return {"ln1": norm_spec(cfg), "mamba": ssm.mamba2_specs(cfg)}
    raise NotImplementedError(kind)


def _stack(specs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every ParamSpec in the tree."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical),
                                        s.init, s.scale), specs)


def _group_specs(cfg: ModelConfig, group_def: tuple[str, ...]) -> dict:
    """The stacked blocks of one group; the shared block lives outside."""
    return {f"b{i}_{kind}": _block_specs(cfg, kind)
            for i, kind in enumerate(group_def) if kind != "shared_attn"}


def model_specs(cfg: ModelConfig) -> dict:
    grp, n_groups, rem = program_for(cfg)
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), "normal",
                           1.0 / math.sqrt(d)),
        "final_norm": norm_spec(cfg),
        "blocks": _stack(_group_specs(cfg, grp), n_groups),
        "tail": {f"t{i}_{k}": _block_specs(cfg, k) for i, k in enumerate(rem)},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                                     "normal", 1.0 / math.sqrt(d))
    if "shared_attn" in grp:
        specs["shared_attn"] = _block_specs(cfg, "attn")
    return specs


def num_params(cfg: ModelConfig) -> int:
    return spec_tree_num_params(model_specs(cfg))


# ------------------------------------------------------------------ forward

def _apply_block(cfg: ModelConfig, kind: str, p: Optional[dict],
                 x: torch.Tensor, shared: Optional[dict], rope, *,
                 plain: bool) -> torch.Tensor:
    """One block, full-sequence mode; ``rope`` is the (sin, cos) of the
    sequence's positions."""
    eps, nk = cfg.norm_eps, cfg.norm
    if kind in _ATTN_KINDS:
        pp = shared if kind == "shared_attn" else p
        h = apply_norm(pp["ln1"], x, eps, nk, plain=plain)
        x = x + attention(pp["attn"], cfg, h, causal=True,
                          window=_window(cfg, kind), rope=rope, plain=plain)
        h = apply_norm(pp["ln2"], x, eps, nk, plain=plain)
        return x + mlp(pp["mlp"], cfg, h)
    if kind == "mamba":
        h = apply_norm(p["ln1"], x, eps, nk, plain=plain)
        return x + ssm.mamba2_forward(p["mamba"], cfg, h, plain=plain)
    raise NotImplementedError(kind)


def _positions_embed(cfg: ModelConfig, params: dict,
                     tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.torch_dtype)
    return x


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
            plain: bool) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.norm,
                   plain=plain)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["unembed"])


def _layer(tree: dict, layer: int) -> dict:
    """One layer's slice (views) of a stacked tree."""
    return tree_map(lambda t: t[layer], tree)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> ``(logits [B, S, V], aux_loss)``; aux is an
    f32 zero (the ported families have no auxiliary loss).  batch:
    ``{"tokens": [B, S]}``.

    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    on-card reference the kernels are held against)."""
    x = _positions_embed(cfg, params, batch["tokens"])
    grp, n_groups, rem = program_for(cfg)
    shared = params.get("shared_attn")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = rope_sin_cos(positions, cfg.hd, cfg.rope_theta)
    for layer in range(n_groups):
        gp = _layer(params["blocks"], layer)
        for i, kind in enumerate(grp):
            p = None if kind == "shared_attn" else gp[f"b{i}_{kind}"]
            x = _apply_block(cfg, kind, p, x, shared, rope, plain=plain)
    for i, kind in enumerate(rem):
        x = _apply_block(cfg, kind, params["tail"][f"t{i}_{kind}"], x, shared,
                         rope, plain=plain)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x, plain=plain), aux


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            plain: bool = False) -> torch.Tensor:
    """Prefill = full forward returning the last position's logits
    ``[B, V]``.  Builds no cache, as the reference's does not."""
    logits, _ = forward(params, cfg, batch, plain=plain)
    return logits[:, -1]


# ------------------------------------------------------------------- decode

#: recurrent states kept in f32 in the cache (the reference's names)
_CACHE_F32 = ("h", "C", "n", "m", "c")


def _block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                       s_max: int) -> dict:
    if kind in _ATTN_KINDS:
        return {n: ParamSpec((batch, s_max, cfg.n_kv_heads, cfg.hd),
                             ("batch", "cache_seq", "kv_heads", "head_dim"),
                             "zeros") for n in ("k", "v")}
    if kind == "mamba":
        d_inner, nheads, headdim = ssm._mamba_dims(cfg)
        return {
            "h": ParamSpec((batch, nheads, headdim, cfg.ssm_state),
                           ("batch", "qheads", None, "state"), "zeros"),
            "conv": ParamSpec((batch, cfg.ssm_conv - 1, d_inner),
                              ("batch", None, "mlp"), "zeros"),
        }
    raise NotImplementedError(kind)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    grp, n_groups, rem = program_for(cfg)
    specs: dict[str, Any] = {
        "blocks": _stack(
            {f"b{i}_{k}": _block_cache_specs(cfg, k, batch, s_max)
             for i, k in enumerate(grp) if k != "shared_attn"}, n_groups),
        "tail": {f"t{i}_{k}": _block_cache_specs(cfg, k, batch, s_max)
                 for i, k in enumerate(rem)},
    }
    if "shared_attn" in grp:
        # one KV cache per application of the shared block
        specs["shared"] = _stack(
            {"attn": _block_cache_specs(cfg, "shared_attn", batch, s_max)},
            n_groups)
    return specs


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: Union[str, torch.device]) -> dict:
    """Zeroed cache tree on ``device``: KV caches and conv windows in the
    compute dtype, recurrent states (``_CACHE_F32``) in f32."""

    def mk(node: Any) -> Any:
        return {name: mk(leaf) if isinstance(leaf, dict) else torch.zeros(
                    leaf.shape, device=device,
                    dtype=torch.float32 if name in _CACHE_F32
                    else cfg.torch_dtype)
                for name, leaf in node.items()}

    return mk(cache_specs(cfg, batch, s_max))


def _decode_block(cfg: ModelConfig, kind: str, p: Optional[dict],
                  x: torch.Tensor, cache: dict, pos: torch.Tensor,
                  shared: Optional[dict], rope, *,
                  plain: bool) -> torch.Tensor:
    """One block; writes this block's cache in place.  ``rope`` is the
    (sin, cos) of ``pos``."""
    eps, nk = cfg.norm_eps, cfg.norm
    if kind in _ATTN_KINDS:
        pp = shared if kind == "shared_attn" else p
        h = apply_norm(pp["ln1"], x, eps, nk, plain=plain)
        y, _, _ = attention_from_cache(pp["attn"], cfg, h, cache["k"],
                                       cache["v"], pos,
                                       window=_window(cfg, kind), rope=rope,
                                       plain=plain)
        x = x + y
        h = apply_norm(pp["ln2"], x, eps, nk, plain=plain)
        return x + mlp(pp["mlp"], cfg, h)
    if kind == "mamba":
        h = apply_norm(p["ln1"], x, eps, nk, plain=plain)
        st = ssm.MambaState(h=cache["h"], conv=cache["conv"])
        y, _ = ssm.mamba2_decode(p["mamba"], cfg, h, st)
        return x + y
    raise NotImplementedError(kind)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                plain: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step.  token ``[B, 1]`` int, pos an int32 scalar tensor
    on the parameters' device.  Returns ``(logits [B, V], cache)``; the
    cache is updated in place (the reference returns a new one).

    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    on-card reference the kernels are held against)."""
    x = _positions_embed(cfg, params, token)
    grp, n_groups, rem = program_for(cfg)
    shared = params.get("shared_attn")
    # once per step, on the device: every attention layer rotates by pos
    rope = rope_sin_cos(pos.reshape(1), cfg.hd, cfg.rope_theta)
    for layer in range(n_groups):
        gp = _layer(params["blocks"], layer)
        gc = _layer(cache["blocks"], layer)
        for i, kind in enumerate(grp):
            if kind == "shared_attn":
                c = _layer(cache["shared"]["attn"], layer)
                x = _decode_block(cfg, kind, None, x, c, pos, shared, rope,
                                  plain=plain)
            else:
                key = f"b{i}_{kind}"
                x = _decode_block(cfg, kind, gp[key], x, gc[key], pos, shared,
                                  rope, plain=plain)
    for i, kind in enumerate(rem):
        key = f"t{i}_{kind}"
        x = _decode_block(cfg, kind, params["tail"][key], x,
                          cache["tail"][key], pos, shared, rope, plain=plain)
    return _logits(params, cfg, x, plain=plain)[:, 0], cache


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
        """One decode step (:func:`decode_step`)."""
        return decode_step(self.tree(), self.cfg, cache, token, pos)

    @torch.inference_mode()
    def prefill(self, batch: dict) -> torch.Tensor:
        """Last-position logits ``[B, V]`` in f32 of a full-sequence
        forward over ``batch["tokens"]`` (:func:`prefill`)."""
        return prefill(self.tree(), self.cfg, batch).float()
