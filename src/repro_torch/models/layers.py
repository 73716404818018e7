"""Decoder layers for one-token decode: RMSNorm, qk-norm, RoPE, attention
against the KV cache, and the MLP (port of ``repro.models.layers``).

Every function is plain PyTorch over explicit parameter dicts with the
reference's key names and shapes, so the JAX package's parameter trees
load unchanged.  The norms call the ``rmsnorm`` kernel wrapper and the
cache attention calls the ``decode_attention`` wrapper; ``plain=True``
routes both to their plain PyTorch versions on any device (the on-card
reference for the kernels).

Left for later slices: full-sequence ``attention`` (flash_attention),
the layernorm branch, and the reference's sharding hints.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 rmsnorm, rmsnorm_plain)
from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = [
    "norm_spec", "apply_norm", "rope_sin_cos", "apply_rope",
    "attention_specs", "attention_from_cache", "mlp_specs", "mlp",
]


# ---------------------------------------------------------------- norms

def norm_spec(cfg: ModelConfig) -> dict:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float, kind: str = "rmsnorm",
               *, plain: bool = False) -> torch.Tensor:
    """RMSNorm with f32 statistics and multiply (the reference's default
    ``f32_mult=True`` branch), through the rmsnorm kernel."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return (rmsnorm_plain if plain else rmsnorm)(x, p["scale"], eps=eps)


def _rms_head(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
              plain: bool = False) -> torch.Tensor:
    """qk-norm: RMS over head_dim with a learned per-dim scale (the same
    kernel, one row per head)."""
    return (rmsnorm_plain if plain else rmsnorm)(x, scale, eps=eps)


# ---------------------------------------------------------------- RoPE

def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions ``[..., S]`` int -> (sin, cos) ``[..., S, head_dim/2]`` f32.
    Computed on the positions' device, so a device ``pos`` never syncs."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Half-split (not interleaved) rotation.  x ``[B, S, N, hd]``;
    sin/cos ``[S, hd/2]`` or ``[B, S, hd/2]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        s, c = sin[None, :, None, :], cos[None, :, None, :]
    else:
        s, c = sin[:, :, None, :], cos[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention

def attention_specs(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    specs = {
        "wq": ParamSpec((d, H, hd), ("attn_in", "qheads", "head_dim"), "normal", s),
        "wk": ParamSpec((d, KV, hd), ("attn_in", "kv_heads", "head_dim"), "normal", s),
        "wv": ParamSpec((d, KV, hd), ("attn_in", "kv_heads", "head_dim"), "normal", s),
        "wo": ParamSpec((H, hd, d), ("qheads", "head_dim", "attn_out_d"), "normal",
                        1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, hd), ("qheads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return specs


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor,
         positions: torch.Tensor, kv_positions: torch.Tensor, use_rope: bool,
         *, plain: bool = False):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", kv_x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps, plain=plain)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps, plain=plain)
    if use_rope:
        sin_q, cos_q = rope_sin_cos(positions, cfg.hd, cfg.rope_theta)
        sin_k, cos_k = rope_sin_cos(kv_positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, sin_q, cos_q)
        k = apply_rope(k, sin_k, cos_k)
    return q, k, v


def attention_from_cache(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    use_rope: bool = True,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: x ``[B, 1, d]``; caches ``[B, S_max, KV, hd]``;
    pos an int32 scalar tensor on x's device.

    Returns ``(attn_out [B, 1, d], k_cache, v_cache)``.  Unlike the
    reference, which returns updated copies (and donates the old ones),
    the port writes the new key and value into the caches IN PLACE at
    ``pos`` (``index_copy_`` on the device position, no host sync) and
    returns the same tensors.  The softmax keeps f32 probabilities
    through the PV product, as the TPU kernel does; the reference's XLA
    path casts them to the compute dtype first, so bf16 results differ
    within bf16 tolerance."""
    positions = pos.reshape(1)
    q, k_new, v_new = _qkv(p, cfg, x, x, positions, positions, use_rope,
                           plain=plain)
    idx = positions.to(torch.long)
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.hd)
    attend = decode_attention_plain if plain else decode_attention
    out = attend(q, k_cache, v_cache, pos, scale=scale, window=window)
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"])
    return y, k_cache, v_cache


# ---------------------------------------------------------------- MLP

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)
    specs = {
        "wi": ParamSpec((d, f), ("embed", "mlp"), "normal", s_in),
        "wo": ParamSpec((f, d), ("mlp", "embed"), "normal", s_out),
    }
    if cfg.mlp_act == "swiglu":
        specs["wg"] = ParamSpec((d, f), ("embed", "mlp"), "normal", s_in)
    return specs


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.mlp_act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = F.silu(g) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.mlp_act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_act)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
