"""Decoder layers: RMSNorm, qk-norm, RoPE, full-sequence attention,
attention against the KV cache, and the MLP (port of
``repro.models.layers``).

Every function is plain PyTorch over explicit parameter dicts with the
reference's key names and shapes, so the JAX package's parameter trees
load unchanged.  The RMS norms call the ``rmsnorm`` kernel wrapper, the
full-sequence attention (self and cross) the ``flash_attention`` wrapper,
the cache attention and the one-query cross-attention of a decode step
the ``decode_attention`` wrapper; ``plain=True`` routes all of them to
plain PyTorch on any device (the on-card reference for the kernels): for
the full-sequence attention that is the reference's own query-blocked
``_sdpa``.  LayerNorm has no TPU kernel and stays plain PyTorch.

The out-projections multiply ``[B, S, H*hd]`` by ``wo`` viewed as
``[H*hd, d]``: the einsum ``bsnh,nhd->bsd`` would copy the whole weight
into a permuted layout on every call.

``attn_block_remat`` checkpoints each query block of the plain path's
attention, as the reference's does; the kernel path stores no
probabilities (its backward recomputes them block by block), so there it
changes nothing.  ``norm_mult_dtype="compute"`` and ``norm_custom_bwd``
are plain PyTorch, as in the reference (:func:`apply_norm`).

**Tensor parallelism.**  The reference's sharding hints (``constrain``
on q, k, v, the heads and the MLP's hidden) let GSPMD split the heads and
the MLP columns over ``model``.  Here the parameters a rank holds say it:
a ``wq`` with fewer than ``cfg.n_heads`` heads, a ``wi`` with fewer than
``cfg.d_ff`` columns, is this rank's block (``models.common.local_tree``
under rules that split ``qheads`` / ``mlp`` over ``model``).  Such a
region starts with ``copy_to_model`` (its input's gradient summed over
``model``) and ends with ``reduce_from_model`` after the row-parallel
``wo`` (the rank's partial output summed), Megatron's pair.  The head
counts come from the local shapes.  Where the rules leave ``wk`` / ``wv``
whole (``kv_heads`` masked to replicated: fewer KV heads than ranks), a
rank cuts out the KV heads its query heads read (head ``h`` reads KV head
``h // G``), so their gradients, and those of ``q_norm`` / ``k_norm``,
are partial sums that the train step adds over ``model``.
Cross-attention takes the same road: a rank projects its query heads
from ``x`` and the KV heads they read from the memory ``kv_x``, which
enters the region through ``copy_to_model`` as ``x`` does (the encoder's
or the patch projection's gradient is the sum of every rank's heads').

**Decode under a mesh** (:func:`attention_from_cache` with a cache
``block``, ``distributed.context.KVBlock``): the caches are this rank's
block of keys and KV heads.  The new key and value are written only by
the rank whose block holds ``pos``.  Where the cache holds more KV heads
than this rank's query heads read (``kv_heads`` replicated while the
query heads split over ``model``), the rank attends with every query
head, gathered over ``model``, and keeps its own after the attention.
Over a cache split by sequence, each rank computes the partials of its
block of keys (``decode_attention_partials``), the ranks all-gather them
over the block's sequence group and each merges them all
(``decode_attention_merge``); the out-projection is row-parallel, as in
:func:`attention`.

``attn_probs_dtype="compute"`` (the reference's perf lever) keeps the
full-sequence attention's scores and probabilities in the compute dtype
with f32 row sums and the normalisation after PV: on the plain path the
reference's own ``_sdpa`` branch, on the kernel path the compute
variant of ``flash_attention`` (``probs="compute"``).  Decode from the
cache does not read it, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import active_ctx
from repro_torch.kernels import (decode_attention, decode_attention_merge,
                                 decode_attention_merge_plain,
                                 decode_attention_partials,
                                 decode_attention_partials_plain,
                                 decode_attention_plain, flash_attention,
                                 rmsnorm, rmsnorm_plain)
from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = [
    "norm_spec", "apply_norm", "RMSNormBF16Bwd", "rope_sin_cos",
    "apply_rope", "attention_specs", "attention", "attention_from_cache",
    "mlp_specs", "mlp", "out_proj",
]

#: masked-score constant of the reference model (``layers.py:_NEG_INF``)
_NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------- norms

def norm_spec(cfg: ModelConfig) -> dict:
    d = {"scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
    return d


class RMSNormBF16Bwd(torch.autograd.Function):
    """RMSNorm with f32 row statistics, multiplies in the compute dtype and
    a hand-written backward that keeps every activation-sized tensor in
    the compute dtype (port of the reference's custom-VJP
    ``_rmsnorm_bf16_bwd``: ``_rmsnorm_bf16_fwd`` / ``_rmsnorm_bf16_rev``,
    ``repro/models/layers.py``, the ``norm_custom_bwd`` lever).

    The reference computes it in plain jnp, not in a Pallas kernel, and it
    is not the rmsnorm kernel's function (that one multiplies in f32), so
    plain PyTorch is its port on every device.  The saved and returned
    tensors are in the compute dtype and the row statistics ``[..., 1]``
    in f32, as in the reference; its contractions of bf16 operands with
    f32 accumulation (``preferred_element_type``) are f32 sums of the
    exact f32 products here, through f32 temporaries of the row's size
    (the sums' order may differ)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ms = x.float().square().sum(dim=-1, keepdim=True) / x.shape[-1]
        inv = torch.rsqrt(ms + eps)                         # [..., 1] f32
        ctx.save_for_backward(x, inv, scale)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, inv, scale = ctx.saved_tensors
        inv_c = inv.to(x.dtype)
        xhat = x * inv_c
        lead = tuple(range(dy.dim() - 1))
        dscale = (dy.float() * xhat.float()).sum(dim=lead).to(scale.dtype)
        dxhat = dy * scale.to(dy.dtype)
        # the row term in f32 (a [..., 1] statistic, like the forward)
        row = (dxhat.float() * xhat.float()).sum(
            dim=-1, keepdim=True) / x.shape[-1]
        dx = inv_c * (dxhat - xhat * row.to(x.dtype))
        return dx, dscale, None


def apply_norm(p: dict, x: torch.Tensor, eps: float, kind: str = "rmsnorm",
               f32_mult: bool = True, custom_bwd: bool = False, *,
               plain: bool = False) -> torch.Tensor:
    """Normalization with f32 statistics (the reference's ``apply_norm``).

    ``f32_mult=True`` (default): the multiplies in f32 too.  RMSNorm goes
    through the rmsnorm kernel; LayerNorm (f32 mean and variance, then
    scale and bias in f32, cast back) is plain PyTorch on both paths.
    ``f32_mult=False`` (``norm_mult_dtype="compute"``) keeps the
    multiplies in the compute dtype, statistics still f32: plain PyTorch,
    as in the reference (the kernel multiplies in f32).
    ``custom_bwd=True`` (rmsnorm only, ``norm_custom_bwd``): the
    hand-written bf16 backward, :class:`RMSNormBF16Bwd`, whatever
    ``f32_mult`` says, as in the reference."""
    if custom_bwd and kind != "layernorm":
        return RMSNormBF16Bwd.apply(x, p["scale"], eps)
    if kind == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        if f32_mult:
            y = (xf - mu) * torch.rsqrt(var + eps)
            return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        mu_c = mu.to(x.dtype)
        return ((x - mu_c) * inv * p["scale"] + p["bias"]).to(x.dtype)
    if kind != "rmsnorm":
        raise ValueError(f"norm {kind!r}")
    if not f32_mult:
        ms = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(ms + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
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

def attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    specs = {
        "wq": ParamSpec((d, H, hd), ("attn_in", "qheads", "head_dim"), "normal", s),
        "wk": ParamSpec((d, KV, hd), ("attn_in", "kv_heads", "head_dim"), "normal", s),
        "wv": ParamSpec((d, KV, hd), ("attn_in", "kv_heads", "head_dim"), "normal", s),
        "wo": ParamSpec((H, hd, d), ("qheads", "head_dim", "attn_out_d"), "normal",
                        1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((H, hd), ("qheads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return specs


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor,
         positions: torch.Tensor, kv_positions: torch.Tensor, use_rope: bool,
         *, rope=None, plain: bool = False):
    """q, k, v projections, qk-norm and RoPE.  ``rope``: the (sin, cos) of
    ``positions``, already computed by the caller for every layer of a
    step, for self-attention (``kv_positions`` the same positions)."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", kv_x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps, plain=plain)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps, plain=plain)
    if use_rope and rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    elif use_rope:
        sin_q, cos_q = rope_sin_cos(positions, cfg.hd, cfg.rope_theta)
        sin_k, cos_k = rope_sin_cos(kv_positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, sin_q, cos_q)
        k = apply_rope(k, sin_k, cos_k)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """``[Sq, Sk]`` f32 additive bias from positional validity."""
    valid = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                       device=q_pos.device)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, _NEG_INF)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor, scale: float,
          probs_dtype: str = "float32") -> torch.Tensor:
    """q ``[B, Sq, KV, G, hd]``, k/v ``[B, Sk, KV, hd]``, bias ``[Sq, Sk]`` ->
    ``[B, Sq, KV, G, hd]``.  ``probs_dtype="float32"`` (the reference's
    default branch): f32 scores and softmax, probabilities rounded to the
    compute dtype before the PV product.  ``"compute"``: the scores, their
    scale and the bias in the compute dtype, the row max held out of the
    gradient, ``p = exp(s - m)`` in the compute dtype, the unnormalised
    PV product, the denominator summed in f32 and the normalisation after
    PV (the reference's compute branch, step for step)."""
    if probs_dtype != "compute":
        scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
        scores = scores + bias[None, None, None]
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    # the scale rounded to the compute dtype, as a Python float: the
    # product rounds once, as the reference's product of two bf16 values
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * torch.tensor(
        scale, dtype=q.dtype).item()
    s = s + bias[None, None, None].to(q.dtype)          # [B, KV, G, Sq, Sk]
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)          # unnormalised
    denom = p.float().sum(dim=-1, keepdim=True)
    inv = (1.0 / denom.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    return o * inv.to(o.dtype)


def _heads_tp(p: dict, cfg: ModelConfig):
    """(the model group, ``p``) when ``p`` holds this rank's block of the
    query heads, with ``wk`` / ``wv`` / ``bk`` / ``bv`` cut to the KV heads
    those query heads read where they are whole; ``(None, p)`` when ``p``
    holds every head."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    h_loc, kv_loc = p["wq"].shape[1], p["wk"].shape[1]
    if h_loc == H:
        if kv_loc != KV:
            raise NotImplementedError(
                f"{cfg.name}: KV heads split over 'model' with the query "
                f"heads whole")
        return None, p
    G = H // KV
    ctx = active_ctx()
    if kv_loc == KV:
        # kv_heads masked to replicated: this rank's query heads
        # [r h_loc, (r + 1) h_loc) read KV heads h // G
        if h_loc % G and G % h_loc:
            raise NotImplementedError(
                f"{cfg.name}: {h_loc} query heads a rank and {G} per KV "
                f"head: a rank's heads would read a ragged KV group")
        kv0 = ctx.mesh.coordinate()["model"] * h_loc // G
        n = max(h_loc // G, 1)
        p = dict(p)
        for k in ("wk", "wv"):
            p[k] = p[k][:, kv0:kv0 + n]
        for k in ("bk", "bv"):
            if k in p:
                p[k] = p[k][kv0:kv0 + n]
    elif h_loc != kv_loc * G:
        raise NotImplementedError(
            f"{cfg.name}: {h_loc} query heads and {kv_loc} KV heads a rank "
            f"(G {G})")
    return ctx.model_group(), p


def out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, hd]`` heads times ``wo [H, hd, d]`` -> ``[B, S, d]``, as
    one product of the views ``[B, S, H*hd]`` and ``[H*hd, d]`` (both
    tensors contiguous, so neither is copied)."""
    B, S, H, hd = out.shape
    return torch.matmul(out.reshape(B, S, H * hd), wo.reshape(H * hd, -1))


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    q_block: int = 1024,
    rope=None,
    plain: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (prefill / forward): x ``[B, Sq, d]`` ->
    ``[B, Sq, d]``, queries at positions 0..Sq-1 and keys at 0..Sk-1 on
    both paths.  ``kv_x`` ``[B, Sk, d]`` switches to cross-attention: keys
    and values from the encoder or vision stream (the callers pass
    ``causal=False, use_rope=False``).

    The kernel path calls ``flash_attention``: an f32 online softmax
    whose probabilities are rounded to bf16 before the PV product at bf16
    (as the reference's XLA path rounds them; the TPU kernel keeps them in
    f32), and kept in f32 at f32.  One query against ``kv_x`` with no mask
    (a decode step's cross-attention) calls ``decode_attention`` at
    ``pos = Sk - 1`` instead, the same function.  Under
    ``cfg.attn_probs_dtype == "compute"`` every kernel call, the one-query
    cross-attention included, is ``flash_attention(probs="compute")``
    (``decode_attention`` keeps f32 probabilities), and the plain path
    takes the reference's compute branch of ``_sdpa``.  ``plain=True``
    runs the reference's exact query-blocked ``_sdpa`` (blocks of ``q_block``
    queries over all keys, or over the ``window - 1 + q_block`` keys a
    sliding-window block can reach; above ``q_block`` queries Sq must be a
    multiple of it, as in the reference), which rounds the probabilities
    to the compute dtype first; at bf16 the two agree within bf16
    tolerance.  ``rope``: the (sin, cos) of positions 0..Sq-1
    (``rope_sin_cos``) for self-attention, computed here when not
    given."""
    # any other value is the float32 mode, as in the reference's _sdpa
    probs = "compute" if cfg.attn_probs_dtype == "compute" else "float32"
    B, Sq, _ = x.shape
    cross = kv_x is not None
    group, p = _heads_tp(p, cfg)
    if group is not None:
        x = C.copy_to_model(x, group)
        if cross:
            # the memory enters the region too: its gradient from this
            # rank's heads is a part, summed over model
            kv_x = C.copy_to_model(kv_x, group)
    kv_x = x if kv_x is None else kv_x
    Sk = kv_x.shape[1]
    positions = torch.arange(Sq, dtype=torch.int32, device=x.device)
    kv_positions = torch.arange(Sk, dtype=torch.int32, device=x.device)

    q, k, v = _qkv(p, cfg, x, kv_x, positions, kv_positions, use_rope,
                   rope=None if cross else rope, plain=plain)
    # this rank's heads (all of them without tensor parallelism)
    H, KV, hd = q.shape[2], k.shape[2], cfg.hd
    G = H // KV
    scale = cfg.attn_scale or 1.0 / math.sqrt(hd)

    if (not plain and cross and Sq == 1 and not causal and window is None
            and probs == "float32"):
        last = torch.full((), Sk - 1, dtype=torch.int32, device=x.device)
        out = decode_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), last, scale=scale)
    elif not plain:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, scale=scale,
                              probs=probs)
    else:
        q = q.reshape(B, Sq, KV, G, hd)
        if Sq <= q_block:
            bias = _mask_bias(positions, kv_positions, causal, window)
            out = _sdpa(q, k, v, bias, scale, probs)
        else:
            # exact query-blocked attention; sliding-window causal layers
            # slice the window - 1 + q_block keys a block can reach
            if Sq % q_block:
                raise ValueError(f"Sq={Sq} is not a multiple of "
                                 f"q_block={q_block}")
            windowed = (window is not None and causal and not cross
                        and window + q_block < Sk)
            # attn_block_remat: recompute each block's f32 probabilities in
            # the backward instead of keeping every block's (training only)
            remat_blocks = bool(cfg.attn_block_remat) and \
                torch.is_grad_enabled()
            outs = []
            for q0 in range(0, Sq, q_block):
                qi = q[:, q0:q0 + q_block]
                pi = positions[q0:q0 + q_block]
                if windowed:
                    span = window - 1 + q_block
                    start = min(max(q0 - (window - 1), 0), Sk - span)
                    kb, vb = k[:, start:start + span], v[:, start:start + span]
                    bias = _mask_bias(pi, kv_positions[start:start + span],
                                      causal, window)
                else:
                    kb, vb = k, v
                    bias = _mask_bias(pi, kv_positions, causal, window)
                if remat_blocks:
                    outs.append(checkpoint(_sdpa, qi, kb, vb, bias, scale,
                                           probs, use_reentrant=False))
                else:
                    outs.append(_sdpa(qi, kb, vb, bias, scale, probs))
            out = torch.cat(outs, dim=1)
    y = out_proj(out.reshape(B, Sq, H, hd), p["wo"])
    return y if group is None else C.reduce_from_model(y, group)


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
    rope=None,
    plain: bool = False,
    block=None,
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
    within bf16 tolerance.  ``rope``: the (sin, cos) of ``pos``
    (``rope_sin_cos``), computed here when not given.

    ``block`` (a ``KVBlock``, under a mesh): x holds the block's batch
    rows and the caches are the block (module docstring)."""
    positions = pos.reshape(1)
    if block is not None:
        return _attention_from_block(p, cfg, x, k_cache, v_cache, pos,
                                     block, window=window, use_rope=use_rope,
                                     rope=rope, plain=plain)
    q, k_new, v_new = _qkv(p, cfg, x, x, positions, positions, use_rope,
                           rope=rope, plain=plain)
    idx = positions.to(torch.long)
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.hd)
    attend = decode_attention_plain if plain else decode_attention
    out = attend(q, k_cache, v_cache, pos, scale=scale, window=window)
    return out_proj(out, p["wo"]), k_cache, v_cache


def _write_block(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 block) -> None:
    """Write ``new`` ``[B, 1, KV, hd]`` at the global position ``pos``
    into a block of keys starting at ``block.k_off``, in place and on the
    device: a rank whose block does not hold ``pos`` writes its row at the
    clamped index back unchanged."""
    if not block.seq_axes:
        cache.index_copy_(1, pos.reshape(1).to(torch.long),
                          new.to(cache.dtype))
        return
    local = pos.reshape(1).to(torch.long) - block.k_off
    owns = ((local >= 0) & (local < cache.shape[1])).view(1, 1, 1, 1)
    idx = local.clamp(0, cache.shape[1] - 1)
    kept = cache.index_select(1, idx)
    cache.index_copy_(1, idx, torch.where(owns, new.to(cache.dtype), kept))


def _attention_from_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: torch.Tensor, block, *,
                          window: Optional[int], use_rope: bool, rope,
                          plain: bool):
    """:func:`attention_from_cache` on this rank's block of the cache
    (decode under a mesh; forward only)."""
    ctx = active_ctx()
    H, G = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    h_loc, kv_c = p["wq"].shape[1], k_cache.shape[2]
    if p["wk"].shape[1] != kv_c or kv_c * G < h_loc:
        raise NotImplementedError(
            f"{cfg.name}: {h_loc} query heads and {p['wk'].shape[1]} KV "
            f"heads a rank against a cache block of {kv_c} KV heads")
    group = ctx.model_group() if h_loc < H else None
    positions = pos.reshape(1)
    q, k_new, v_new = _qkv(p, cfg, x, x, positions, positions, use_rope,
                           rope=rope, plain=plain)
    _write_block(k_cache, k_new, pos, block)
    _write_block(v_cache, v_new, pos, block)
    # the cache holds every KV head while this rank holds some query
    # heads: attend with all of them, keep this rank's after
    every_head = kv_c * G > h_loc
    if every_head:
        q = C.all_gather_cat(q.contiguous(), group, dim=2)
    q = q.contiguous()
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.hd)
    if block.seq_axes:
        partials = (decode_attention_partials_plain if plain
                    else decode_attention_partials)
        merge = decode_attention_merge_plain if plain else \
            decode_attention_merge
        parts = partials(q, k_cache, v_cache, pos, k_off=block.k_off,
                         scale=scale, window=window)
        parts = C.all_gather_stacked(parts, ctx.mesh.group(block.seq_axes))
        out = merge(parts, q, kv_c)
    else:
        attend = decode_attention_plain if plain else decode_attention
        out = attend(q, k_cache, v_cache, pos, scale=scale, window=window)
    if every_head:
        h0 = ctx.mesh.coordinate()["model"] * h_loc
        out = out[:, :, h0:h0 + h_loc]
    y = out_proj(out.contiguous(), p["wo"])
    return (y if group is None else C.reduce_from_model(y, group)), \
        k_cache, v_cache


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
    """The MLP; on this rank's block of its columns (``wi`` / ``wg``
    column-parallel, ``wo`` row-parallel) when ``wi`` holds fewer than
    ``cfg.d_ff``."""
    group = None
    if p["wi"].shape[-1] < cfg.d_ff:
        group = active_ctx().model_group()
        x = C.copy_to_model(x, group)
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
    y = torch.einsum("bsf,fd->bsd", h, p["wo"])
    return y if group is None else C.reduce_from_model(y, group)
