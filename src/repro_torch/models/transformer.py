"""Model assembly: the full-sequence forward and prefill, and the
one-token decode step, for every family of the reference (port of
``repro.models.transformer``).

The parameter tree keeps the reference's layout: each group of the
program stacked on a leading axis under ``blocks/b<i>_<kind>`` (so a
dense ``wq`` is ``[L, d, H, hd]``), a ``tail`` for the remainder layers,
for the hybrid family one ``shared_attn`` block outside the stack, and for
the encoder-decoder an ``encoder`` stack; a ``frontend_proj`` maps the
stub frame / patch embeddings into the model, so a checkpoint crosses
between the packages by key.  The reference's ``lax.scan`` over the stack
is a Python loop over the leading axis here.

Programs (``program_for``): dense global attention (qwen3, qwen2.5,
nemotron), the dense local/global program (gemma3; local layers attend
within ``cfg.attn_window``), the hybrid (``("mamba",) * period +
("shared_attn",)`` per group, zamba2), MoE (``("moe",) * L``: attention
plus the expert FFN, olmoe, kimi-k2), xLSTM (``("mlstm",) * (N - 1) +
("slstm",)`` per group, xlstm), the VLM (``("attn",) * (N - 1) +
("xattn",)`` per group: a ``tanh(gate)``-scaled cross-attention to the
projected patches, llama-3.2-vision) and the encoder-decoder
(``("dec_attn",) * L``: self, cross and MLP, over a bidirectional
encoder's output, whisper).  The memory (encoder output or projected
patches) is computed by ``forward`` and, for decode, held in the cache's
``memory`` leaf, which the caller writes.  The RoPE sin / cos of the
step's positions are computed once per forward or decode step and shared
by every rotary layer; the encoder-decoder and every cross-attention use
no RoPE, as in the reference.  ``forward`` builds no cache, as the
reference's does not; ``generate`` prefills through the decode step.

Training: :func:`lm_loss` is the reference's loss (both ``loss_dtype``
paths).  ``remat`` checkpoints each group of the stack (and each encoder
layer), as the reference's ``_remat_wrap`` does the body of its scan,
only while grad is enabled; ``norm_mult_dtype`` and ``norm_custom_bwd``
select the reference's norm variants (``layers.apply_norm``);
``attn_block_remat`` acts on the plain attention path
(``layers.attention``); ``seq_shard_norms`` is a sharding hint that
changes nothing on one card.  Serving and prefill run under
``inference_mode`` and never checkpoint.

**Tensor parallelism** (under an active sharding context whose rules
split the dense leaves over ``model``, ``models.common.local_tree``
blocks): the attention heads and MLP columns as ``layers`` says; the
embedding split over the vocabulary: each rank looks up the tokens in its
rows (the rest read zeros) and ``reduce_from_model`` sums the ranks'
rows; the logits are this rank's vocabulary block of the final hidden
state (after ``copy_to_model``), which ``forward`` gathers whole and
:func:`lm_loss` never does: its cross-entropy is vocab-parallel
(:class:`_VocabParallelNLL`).  A tied embedding is one ``[V / M, d]``
leaf for both uses, so autograd adds its two gradients.  Leaves the rules
store split over data axes (FSDP) are gathered before each block
(``models.common.fsdp_gather``), again in the recompute under ``remat``.

The hybrid (zamba2) and ssm (xlstm) families take the same road: their
shared attention block and tied embedding as the dense family's, their
Mamba2, mLSTM and sLSTM blocks as ``models.ssm`` says.  So do the encdec
(whisper) and vlm (llama-vision) families: cross-attention on a rank's
heads (``layers.attention``; the memory enters the region through
``copy_to_model``), and :func:`encode` gathers ``frontend_proj`` and the
encoder's final norm as :func:`_top` gathers ``embed``, each encoder
block its own leaves.

**Decode under a mesh** (every family, under rules such as
``launch.dryrun.serve_rules``'s): :func:`init_cache` allocates this
rank's block of every cache leaf (``ShardingCtx.kv_block`` for a KV leaf:
batch rows, keys and KV heads; ``ShardingCtx.block`` for a recurrent
state: batch rows, and heads or ``d_inner`` where the rules cut them; the
``memory`` of encdec and vlm: batch rows, ``ShardingCtx.batch_rows``),
never the whole cache.  :func:`decode_step` takes the global ``token``
``[B, 1]``, runs this rank's batch rows (``ShardingCtx.batch_rows`` of
the global batch) through the layers (FSDP leaves gathered per layer,
heads, MLP columns and vocabulary over ``model``, attention over the
cache block as ``layers.attention_from_cache`` says, cross-attention of
the rank's heads over its memory rows, the MoE one-hot path over every
rank's tokens as ``models.moe`` says, a Mamba2 block on its block of the
heads; a block that computes with a whole state the rules cut over
``model`` gathers it and writes back its block) and gathers the logits
over the vocabulary and the batch rows, so every rank returns the same
``[B, V]``.  It is forward-only (it raises with grad enabled on
parameters that require it).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import KV_CACHE_LOGICAL, active_ctx
from repro_torch.models import ssm
from repro_torch.models.common import (ModelConfig, ParamSpec, fsdp_gather,
                                       init_params, spec_tree_num_params,
                                       tree_leaves, tree_map)
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.layers import (apply_norm, attention,
                                       attention_from_cache, attention_specs,
                                       mlp, mlp_specs, norm_spec,
                                       rope_sin_cos)

__all__ = ["program_for", "model_specs", "encode", "forward", "lm_loss",
           "prefill", "cache_specs", "init_cache", "decode_step",
           "num_params", "active_params", "Decoder"]


# ------------------------------------------------------------------ programs

def program_for(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """(group_def, n_groups, remainder_def) for the decoder stack."""
    L = cfg.n_layers
    if cfg.family == "moe":
        return ("moe",), L, ()
    if cfg.family == "hybrid":
        per = cfg.hybrid_period
        return ("mamba",) * per + ("shared_attn",), L // per, \
            ("mamba",) * (L % per)
    if cfg.family == "ssm":
        per = cfg.slstm_every
        return ("mlstm",) * (per - 1) + ("slstm",), L // per, \
            ("mlstm",) * (L % per)
    if cfg.family == "vlm":
        per = cfg.cross_attn_period
        return ("attn",) * (per - 1) + ("xattn",), L // per, \
            ("attn",) * (L % per)
    if cfg.family == "encdec":
        return ("dec_attn",), L, ()
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.local_global_pattern:
        per = cfg.local_global_pattern + 1
        grp = ("attn_local",) * cfg.local_global_pattern + ("attn_global",)
        return grp, L // per, ("attn_local",) * (L % per)
    return ("attn",), L, ()


#: block kinds made of self-attention + MLP (``shared_attn`` uses the
#: shared parameters; ``attn_local`` attends within ``cfg.attn_window``;
#: ``attn_bidir`` is the encoder's, with no causal mask)
_ATTN_KINDS = ("attn", "attn_local", "attn_global", "attn_bidir",
               "shared_attn")


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn_window if kind == "attn_local" else None


def _rotary(cfg: ModelConfig) -> bool:
    """Whether the decoder's self-attention rotates q and k (the
    reference's ``use_rope = cfg.family != "encdec"``)."""
    return cfg.family != "encdec"


@functools.lru_cache(maxsize=None)
def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    """One block's specs (cached: the FSDP gather reads them every layer;
    callers copy before changing them)."""
    if kind in _ATTN_KINDS:
        return {"ln1": norm_spec(cfg), "attn": attention_specs(cfg),
                "ln2": norm_spec(cfg), "mlp": mlp_specs(cfg)}
    if kind == "moe":
        return {"ln1": norm_spec(cfg), "attn": attention_specs(cfg),
                "ln2": norm_spec(cfg), "moe": moe_specs(cfg)}
    if kind == "xattn":
        return {"ln1": norm_spec(cfg),
                "xattn": attention_specs(cfg, cross=True),
                "gate": ParamSpec((1,), (None,), "zeros"),
                "ln2": norm_spec(cfg), "mlp": mlp_specs(cfg)}
    if kind == "dec_attn":
        return {"ln1": norm_spec(cfg), "attn": attention_specs(cfg),
                "ln_x": norm_spec(cfg),
                "xattn": attention_specs(cfg, cross=True),
                "ln2": norm_spec(cfg), "mlp": mlp_specs(cfg)}
    if kind == "mamba":
        return {"ln1": norm_spec(cfg), "mamba": ssm.mamba2_specs(cfg)}
    if kind == "mlstm":
        return {"ln1": norm_spec(cfg), "mlstm": ssm.mlstm_specs(cfg)}
    if kind == "slstm":
        specs = {"ln1": norm_spec(cfg), "slstm": ssm.slstm_specs(cfg)}
        if cfg.d_ff > 0:
            specs["ln2"] = norm_spec(cfg)
            specs["mlp"] = mlp_specs(cfg)
        return specs
    raise ValueError(kind)


def _copy(specs: Any) -> Any:
    return tree_map(lambda s: s, specs)


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
        "tail": {f"t{i}_{k}": _copy(_block_specs(cfg, k))
                 for i, k in enumerate(rem)},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                                     "normal", 1.0 / math.sqrt(d))
    if "shared_attn" in grp:
        specs["shared_attn"] = _copy(_block_specs(cfg, "attn"))
    if cfg.family == "encdec":
        specs["encoder"] = {
            "blocks": _stack(_group_specs(cfg, ("attn_bidir",)),
                             cfg.n_encoder_layers),
            "final_norm": norm_spec(cfg),
        }
    if cfg.frontend_dim:
        specs["frontend_proj"] = ParamSpec(
            (cfg.frontend_dim, d), ("frames", "embed"), "normal",
            1.0 / math.sqrt(cfg.frontend_dim))
    return specs


def num_params(cfg: ModelConfig) -> int:
    return spec_tree_num_params(model_specs(cfg))


def active_params(cfg: ModelConfig) -> int:
    """MoE: parameters touched per token (all of them elsewhere)."""
    total = num_params(cfg)
    if cfg.family != "moe":
        return total
    _, n_groups, _ = program_for(cfg)
    moe = model_specs(cfg)["blocks"]["b0_moe"]["moe"]
    e_params = per_expert_per_layer = 0
    for name in ("wi", "wg", "wo"):
        if name in moe:
            # stacked shape = (n_groups, E, ...)
            n = math.prod(moe[name].shape)
            e_params += n
            per_expert_per_layer += n // (cfg.n_experts * n_groups)
    return total - e_params + n_groups * cfg.top_k * per_expert_per_layer


# ------------------------------------------------------------------ forward

def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
          plain: bool) -> torch.Tensor:
    """The config's norm (``apply_norm`` with its ``norm_mult_dtype`` and
    ``norm_custom_bwd`` levers).  ``seq_shard_norms``, the reference's
    sequence-parallel sharding hint for these segments, changes nothing on
    one card and is not read."""
    return apply_norm(p, x, cfg.norm_eps, cfg.norm,
                      cfg.norm_mult_dtype == "float32",
                      bool(cfg.norm_custom_bwd), plain=plain)


def _apply_block(cfg: ModelConfig, kind: str, p: Optional[dict],
                 x: torch.Tensor, memory: Optional[torch.Tensor],
                 shared: Optional[dict], rope, *, plain: bool,
                 q_block: int) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block, full-sequence mode -> (x, the block's load-balance loss
    or ``None``).  ``memory``: the encoder / vision stream; ``rope``: the
    (sin, cos) of the sequence's positions (``None`` for the encdec
    family, which rotates nothing)."""
    def norm(pn, t):
        return _norm(cfg, pn, t, plain=plain)

    def attend(pa, t, **kw):
        return attention(pa, cfg, t, rope=rope, plain=plain,
                         q_block=q_block, **kw)

    if active_ctx() is not None:
        if kind == "shared_attn":
            shared = fsdp_gather(shared, _block_specs(cfg, "attn"))
        else:
            p = fsdp_gather(p, _block_specs(cfg, kind))
    if kind in _ATTN_KINDS:
        pp = shared if kind == "shared_attn" else p
        x = x + attend(pp["attn"], norm(pp["ln1"], x),
                       causal=kind != "attn_bidir", window=_window(cfg, kind),
                       use_rope=_rotary(cfg))
        return x + mlp(pp["mlp"], cfg, norm(pp["ln2"], x)), None
    if kind == "moe":
        x = x + attend(p["attn"], norm(p["ln1"], x), causal=True)
        y, lb = moe_block(p["moe"], cfg, norm(p["ln2"], x))
        return x + y, lb
    if kind == "xattn":
        y = attend(p["xattn"], norm(p["ln1"], x), kv_x=memory, causal=False,
                   use_rope=False)
        x = x + torch.tanh(p["gate"].float()).to(x.dtype) * y
        return x + mlp(p["mlp"], cfg, norm(p["ln2"], x)), None
    if kind == "dec_attn":
        x = x + attend(p["attn"], norm(p["ln1"], x), causal=True,
                       use_rope=False)
        x = x + attend(p["xattn"], norm(p["ln_x"], x), kv_x=memory,
                       causal=False, use_rope=False)
        return x + mlp(p["mlp"], cfg, norm(p["ln2"], x)), None
    if kind == "mamba":
        return x + ssm.mamba2_forward(p["mamba"], cfg, norm(p["ln1"], x),
                                      plain=plain), None
    if kind == "mlstm":
        return x + ssm.mlstm_forward(p["mlstm"], cfg, norm(p["ln1"], x)), None
    if kind == "slstm":
        x = x + ssm.slstm_forward(p["slstm"], cfg, norm(p["ln1"], x))
        if cfg.d_ff > 0:
            x = x + mlp(p["mlp"], cfg, norm(p["ln2"], x))
        return x, None
    raise ValueError(kind)


#: matmul-like ops whose outputs the ``"dots"`` policy saves (the
#: reference's ``checkpoint_dots``); everything else is recomputed
_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "linear")


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op._opname in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: ModelConfig, fn):
    """The reference's ``_remat_wrap``: ``remat="full"`` checkpoints ``fn``
    (saves nothing inside it, recomputes it in the backward), ``"dots"``
    saves only the outputs of matrix products, ``"none"`` leaves it as it
    is.  Only while grad is enabled: serving and prefill run ``fn`` bare.
    Under ``"full"`` every kernel inside ``fn`` launches twice per
    training step (forward and recompute)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if cfg.remat == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped


def _top(params: dict, cfg: ModelConfig) -> dict:
    """The leaves outside the stack -- ``embed``, ``unembed``,
    ``final_norm`` -- as the model computes with them (FSDP dims
    gathered, ``models.common.fsdp_gather``)."""
    top = {k: params[k] for k in ("embed", "unembed", "final_norm")
           if k in params}
    if active_ctx() is None:
        return top
    specs = model_specs(cfg)
    return fsdp_gather(top, {k: specs[k] for k in top})


def _vocab_block(cfg: ModelConfig, embed: torch.Tensor):
    """(model group, first row) of this rank's vocabulary block when
    ``embed`` holds fewer than ``cfg.vocab_size`` rows, else ``None``."""
    n = embed.shape[0]
    if n == cfg.vocab_size:
        return None
    ctx = active_ctx()
    return ctx.model_group(), ctx.mesh.coordinate()["model"] * n


def _positions_embed(cfg: ModelConfig, params: dict,
                     tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    vb = _vocab_block(cfg, emb)
    if vb is None:
        x = emb[tokens].to(cfg.torch_dtype)
    else:
        # this rank's rows; tokens outside them read zeros, and the sum
        # over model holds each token's one row
        group, v0 = vb
        local = tokens.long() - v0
        mine = (local >= 0) & (local < emb.shape[0])
        x = emb[torch.where(mine, local, 0)] * mine[..., None].to(emb.dtype)
        x = C.reduce_from_model(x.to(cfg.torch_dtype), group)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.torch_dtype)
    return x


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
            plain: bool, whole: bool = True) -> torch.Tensor:
    """The logits of the final hidden state: all of them, or with
    ``whole=False`` this rank's vocabulary block (the whole when the
    vocabulary is not split)."""
    x = _norm(cfg, params["final_norm"], x, plain=plain)
    vb = _vocab_block(cfg, params["embed"])
    if vb is not None:
        x = C.copy_to_model(x, vb[0])
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    if vb is not None and whole:
        logits = C.gather(logits, vb[0], dim=-1)
    return logits


def _layer(tree: dict, layer: int) -> dict:
    """One layer's slice (views) of a stacked tree."""
    return tree_map(lambda t: t[layer], tree)


def encode(params: dict, cfg: ModelConfig, batch: dict, *,
           plain: bool = False,
           q_block: int = 1024) -> Optional[torch.Tensor]:
    """The memory cross-attention reads ``[B, M, d]``: for encdec the
    encoder (bidirectional attention blocks, no RoPE, its final norm) over
    the stub frame embeddings ``batch["frames"]``, for vlm the projected
    ``batch["patches"]``; ``None`` for the other families.  A decode step
    reads it from ``cache["memory"]``.

    Under an active context ``frontend_proj`` and the encoder's final
    norm have their FSDP dims gathered as :func:`_top` gathers ``embed``,
    each encoder block its own (:func:`_apply_block`, again in the
    recompute)."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    specs = model_specs(cfg)
    proj = fsdp_gather(params["frontend_proj"], specs["frontend_proj"])
    if cfg.family == "vlm":
        return torch.matmul(batch["patches"].to(cfg.torch_dtype), proj)
    x = torch.matmul(batch["frames"].to(cfg.torch_dtype), proj)
    enc = params["encoder"]

    def layer_fn(x, p):
        return _apply_block(cfg, "attn_bidir", p, x, None, None, None,
                            plain=plain, q_block=q_block)[0]

    layer_fn = _remat_wrap(cfg, layer_fn)
    for layer in range(cfg.n_encoder_layers):
        x = layer_fn(x, _layer(enc["blocks"], layer)["b0_attn_bidir"])
    final = fsdp_gather(enc["final_norm"], specs["encoder"]["final_norm"])
    return _norm(cfg, final, x, plain=plain)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            plain: bool = False,
            q_block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> ``(logits [B, S, V], aux_loss)``; aux is
    the f32 sum of the MoE blocks' load-balance losses (zero for the other
    families).  batch: ``{"tokens": [B, S]}``, plus ``"frames"`` ``[B,
    S_enc, F]`` for encdec and ``"patches"`` ``[B, P, F]`` for vlm.

    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    on-card reference the kernels are held against); ``q_block`` is its
    attention's query block (the reference's default 1024; above it the
    sequence must be a multiple of it)."""
    top = _top(params, cfg)
    x, aux = _hidden(params, cfg, batch, top, plain=plain, q_block=q_block)
    return _logits(top, cfg, x, plain=plain), aux


def _hidden(params: dict, cfg: ModelConfig, batch: dict, top: dict, *,
            plain: bool, q_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stack's output before the final norm, and the aux loss."""
    x = _positions_embed(cfg, top, batch["tokens"])
    memory = encode(params, cfg, batch, plain=plain, q_block=q_block)
    grp, n_groups, rem = program_for(cfg)
    shared = params.get("shared_attn")
    rope = None
    if _rotary(cfg):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        rope = rope_sin_cos(positions, cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(kind, p, x, aux):
        x, lb = _apply_block(cfg, kind, p, x, memory, shared, rope,
                             plain=plain, q_block=q_block)
        return x, aux if lb is None else aux + lb

    def group(x, aux, gp, shared):
        for i, kind in enumerate(grp):
            p = None if kind == "shared_attn" else gp[f"b{i}_{kind}"]
            x, aux = run(kind, p, x, aux)
        return x, aux

    # the reference checkpoints the body of its scan over groups; the
    # shared block's parameters go in as arguments, so a recompute sees
    # the same tensors
    group = _remat_wrap(cfg, group)
    for layer in range(n_groups):
        x, aux = group(x, aux, _layer(params["blocks"], layer), shared)
    for i, kind in enumerate(rem):
        x, aux = run(kind, params["tail"][f"t{i}_{kind}"], x, aux)
    return x, aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01, *, plain: bool = False,
            q_block: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance loss, an f32 scalar (port of the reference's
    ``lm_loss``).

    ``loss_dtype="float32"``: the logits in f32, their f32 log-sum-exp,
    minus the label logit.  The reference takes the label logit as an f32
    one-hot contraction over the vocabulary; here it is a gather, which
    for finite logits is the same value (every other term of the
    contraction is an exact 0) and the same gradient (1 at the label, 0
    elsewhere), without an f32 ``[B, S, V]`` one-hot.
    ``loss_dtype="compute"``: the label logit gathered from the
    compute-dtype logits, the log-sum-exp still in f32, as in the
    reference.  ``plain`` and ``q_block`` as for :func:`forward`.

    With the vocabulary split over ``model`` the logits stay this rank's
    block ``[B, S, V / M]`` and the cross-entropy is vocab-parallel
    (:class:`_VocabParallelNLL`, either ``loss_dtype``): no rank holds the
    whole ``[B, S, V]``."""
    top = _top(params, cfg)
    x, aux = _hidden(params, cfg, batch, top, plain=plain, q_block=q_block)
    logits = _logits(top, cfg, x, plain=plain, whole=False)
    targets = batch["tokens"][:, 1:].long()[..., None]
    logits = logits[:, :-1]
    vb = _vocab_block(cfg, top["embed"])
    if vb is not None:
        nll = _VocabParallelNLL.apply(logits, targets[..., 0], vb[1], vb[0],
                                      cfg.loss_dtype == "compute")
        return nll.mean() + aux_weight * aux
    if cfg.loss_dtype == "compute":
        lse = torch.logsumexp(logits.float(), dim=-1)
        label = torch.gather(logits, -1, targets)[..., 0].float()
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        label = torch.gather(logits, -1, targets)[..., 0]
    return (lse - label).mean() + aux_weight * aux


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``lse - label logit`` (f32 ``[B, S]``) of logits split
    over the vocabulary: ``logits`` ``[B, S, V / M]`` is this rank's block,
    starting at row ``v0``.  The row max is all-reduced as a max (it
    carries no gradient), the sum of exponentials as a sum, and the label
    logit from the rank whose block holds the label (zero elsewhere) as a
    sum, so every model rank returns the same values.  Backward: the local
    softmax block minus the local one-hot block, times the incoming
    gradient, in the logits' dtype; with ``compute`` (``loss_dtype=
    "compute"``) the two terms are rounded to it apart, as the reference's
    two cotangents are."""

    @staticmethod
    def forward(ctx, logits, targets, v0, group, compute):
        lf = logits.float()
        m = lf.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = torch.exp(lf - m[..., None]).sum(dim=-1)
        dist.all_reduce(se, group=group)
        lse = m + torch.log(se)
        local = targets - v0
        mine = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(mine, local, 0)
        label = torch.gather(lf, -1, local[..., None])[..., 0]
        label = torch.where(mine, label, torch.zeros_like(label))
        dist.all_reduce(label, group=group)
        ctx.save_for_backward(logits, lse, local, mine)
        ctx.compute = compute
        return lse - label

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine = ctx.saved_tensors
        soft = torch.exp(logits.float() - lse[..., None]) * g[..., None]
        hot = torch.where(mine, g, torch.zeros_like(g))[..., None]
        if ctx.compute:
            grad = soft.to(logits.dtype)
            grad.scatter_add_(-1, local[..., None],
                              -hot.to(logits.dtype))
        else:
            grad = soft.scatter_add_(-1, local[..., None], -hot)
            grad = grad.to(logits.dtype)
        return grad, None, None, None, None


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
    if kind in _ATTN_KINDS or kind in ("moe", "dec_attn"):
        return {n: ParamSpec((batch, s_max, cfg.n_kv_heads, cfg.hd),
                             ("batch", "cache_seq", "kv_heads", "head_dim"),
                             "zeros") for n in ("k", "v")}
    if kind == "xattn":
        return {}       # the memory's K / V are recomputed every step
    if kind == "mamba":
        d_inner, nheads, headdim = ssm._mamba_dims(cfg)
        return {
            "h": ParamSpec((batch, nheads, headdim, cfg.ssm_state),
                           ("batch", "qheads", None, "state"), "zeros"),
            "conv": ParamSpec((batch, cfg.ssm_conv - 1, d_inner),
                              ("batch", None, "mlp"), "zeros"),
        }
    if kind == "mlstm":
        H, hdm, _ = ssm._mlstm_dims(cfg)
        return {
            "C": ParamSpec((batch, H, hdm, hdm),
                           ("batch", "qheads", "head_dim", None), "zeros"),
            "n": ParamSpec((batch, H, hdm), ("batch", "qheads", "head_dim"),
                           "zeros"),
            "m": ParamSpec((batch, H), ("batch", "qheads"), "zeros"),
        }
    if kind == "slstm":
        H, hdm = ssm._slstm_dims(cfg)
        return {n: ParamSpec((batch, H, hdm), ("batch", "qheads", "head_dim"),
                             "zeros") for n in ("c", "n", "h", "m")}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                mem_len: int = 0) -> dict:
    """Spec tree of the decode cache; encdec and vlm also hold the
    ``memory`` ``[batch, mem_len, d]`` their cross-attention reads."""
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
    if cfg.family in ("encdec", "vlm"):
        specs["memory"] = ParamSpec((batch, mem_len, cfg.d_model),
                                    ("batch", "frames", "embed"), "zeros")
    return specs


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: Union[str, torch.device], *,
               mem_len: int = 0) -> dict:
    """Zeroed cache tree on ``device``: KV caches, conv windows and the
    memory in the compute dtype, recurrent states (``_CACHE_F32``) in
    f32.  The caller writes ``memory`` (encdec, vlm) before decoding.

    Under an active sharding context each leaf is this rank's block of
    the ``batch x s_max`` cache: a KV leaf's as ``ShardingCtx.kv_block``
    gives it, which the decode step then finds by the batch and its local
    shape, a recurrent state's as ``ShardingCtx.block`` gives it from its
    logical axes (a stacked leaf's ``layers`` dim stays whole), the
    ``memory``'s its batch rows (``ShardingCtx.batch_rows``: the
    cross-attention reads every frame and the whole ``d``, as the
    reference's compute rules lay it out)."""
    ctx = active_ctx()

    def shape_of(name: str, leaf: ParamSpec) -> tuple:
        if ctx is None:
            return leaf.shape
        if name == "memory":
            rows = ctx.batch_rows(batch)[0]
            return (rows.stop - rows.start, *leaf.shape[1:])
        if tuple(leaf.logical[-4:]) == KV_CACHE_LOGICAL:
            return (*leaf.shape[:-4],
                    *ctx.kv_block(leaf.shape[-4:]).local_shape)
        lead = int(leaf.logical[0] == "layers")
        return (*leaf.shape[:lead], *(
            sl.stop - sl.start for sl in ctx.block(leaf.logical[lead:],
                                                   leaf.shape[lead:])))

    def mk(node: Any) -> Any:
        return {name: mk(leaf) if isinstance(leaf, dict) else torch.zeros(
                    shape_of(name, leaf), device=device,
                    dtype=torch.float32 if name in _CACHE_F32
                    else cfg.torch_dtype)
                for name, leaf in node.items()}

    return mk(cache_specs(cfg, batch, s_max, mem_len))


def _state_cuts(ctx, cfg: ModelConfig, kind: str, batch: int) -> list:
    """(state, dim, this rank's slice) of each recurrent state of a
    ``kind`` block that the rules cut over ``model`` while the block
    computes with it whole (every head, ``ssm.state_whole``): the decode
    step gathers it and writes back its block (once per context)."""
    key = ("state_cuts", cfg, kind, batch)
    if key not in ctx.memo:
        if kind in ("mlstm", "slstm"):
            ssm.check_heads(cfg, kind)     # before the gather below
        cuts = []
        if ctx.axis_size("model") > 1 and ssm.state_whole(cfg, kind):
            for name, s in _block_cache_specs(cfg, kind, batch, 1).items():
                for dim, axes in enumerate(ctx.layout(s.logical, s.shape)):
                    if "model" in axes:
                        if axes != ("model",):
                            raise NotImplementedError(
                                f"{cfg.name}: the {kind} state {name} "
                                f"split over {axes} (ROADMAP Queue 1 "
                                f"item 2)")
                        cuts.append((name, dim,
                                     ctx.block(s.logical, s.shape)[dim]))
        ctx.memo[key] = cuts
    return ctx.memo[key]


def _decode_block(cfg: ModelConfig, kind: str, p: Optional[dict],
                  x: torch.Tensor, cache: dict, pos: torch.Tensor,
                  memory: Optional[torch.Tensor], shared: Optional[dict],
                  rope, *, plain: bool, block=None) -> torch.Tensor:
    """One block; writes this block's cache in place.  ``rope`` is the
    (sin, cos) of ``pos`` (``None`` for the encdec family); ``block`` the
    KV cache's ``KVBlock`` under a mesh (a recurrent block's ``cache`` is
    its states as it computes with them, :func:`_state_cuts`)."""
    def norm(pn, t):
        return _norm(cfg, pn, t, plain=plain)

    def self_attend(pa, t, **kw):
        y, _, _ = attention_from_cache(pa, cfg, t, cache["k"], cache["v"],
                                       pos, rope=rope, plain=plain,
                                       block=block, **kw)
        return y

    def cross_attend(pa, t):
        return attention(pa, cfg, t, kv_x=memory, causal=False,
                         use_rope=False, plain=plain)

    if kind in _ATTN_KINDS or kind == "moe":
        pp = shared if kind == "shared_attn" else p
        x = x + self_attend(pp["attn"], norm(pp["ln1"], x),
                            window=_window(cfg, kind), use_rope=_rotary(cfg))
        h = norm(pp["ln2"], x)
        if kind == "moe":
            return x + moe_block(p["moe"], cfg, h, batch_axes=None
                                 if block is None else block.batch_axes)[0]
        return x + mlp(pp["mlp"], cfg, h)
    if kind == "dec_attn":
        x = x + self_attend(p["attn"], norm(p["ln1"], x), use_rope=False)
        x = x + cross_attend(p["xattn"], norm(p["ln_x"], x))
        return x + mlp(p["mlp"], cfg, norm(p["ln2"], x))
    if kind == "xattn":
        y = cross_attend(p["xattn"], norm(p["ln1"], x))
        x = x + torch.tanh(p["gate"].float()).to(x.dtype) * y
        return x + mlp(p["mlp"], cfg, norm(p["ln2"], x))
    if kind == "mamba":
        st = ssm.MambaState(h=cache["h"], conv=cache["conv"])
        return x + ssm.mamba2_decode(p["mamba"], cfg, norm(p["ln1"], x),
                                     st)[0]
    if kind == "mlstm":
        st = ssm.MLSTMState(C=cache["C"], n=cache["n"], m=cache["m"])
        return x + ssm.mlstm_decode(p["mlstm"], cfg, norm(p["ln1"], x),
                                    st)[0]
    if kind == "slstm":
        st = ssm.SLSTMState(c=cache["c"], n=cache["n"], h=cache["h"],
                            m=cache["m"])
        x = x + ssm.slstm_decode(p["slstm"], cfg, norm(p["ln1"], x), st)[0]
        if cfg.d_ff > 0:
            x = x + mlp(p["mlp"], cfg, norm(p["ln2"], x))
        return x
    raise ValueError(kind)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                plain: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step.  token ``[B, 1]`` int, pos an int32 scalar tensor
    on the parameters' device.  Returns ``(logits [B, V], cache)``; the
    cache is updated in place (the reference returns a new one).  encdec
    and vlm read ``cache["memory"]``.

    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    on-card reference the kernels are held against).  Under an active
    sharding context, ``params`` are this rank's blocks and ``cache`` the
    blocks ``init_cache`` allocated under the same context; ``token`` is
    the whole batch and every rank returns the whole ``[B, V]`` (module
    docstring)."""
    ctx = active_ctx()
    B = token.shape[0]
    block, rows, batch_axes = None, slice(0, B), ()
    if ctx is not None:
        if torch.is_grad_enabled() and any(
                t.requires_grad for _, t in tree_leaves(params)):
            raise NotImplementedError(
                f"{cfg.name}: decode under a mesh is forward-only (its "
                f"collectives carry no gradient); run it under no_grad")
        rows, batch_axes = ctx.batch_rows(B)
        block = _cache_block(ctx, cfg, cache, B)
    top = _top(params, cfg)
    x = _positions_embed(cfg, top, token[rows])
    grp, n_groups, rem = program_for(cfg)
    shared = params.get("shared_attn")
    memory = cache.get("memory")
    # once per step, on the device: every rotary layer rotates by pos
    rope = (rope_sin_cos(pos.reshape(1), cfg.hd, cfg.rope_theta)
            if _rotary(cfg) else None)

    def run(kind, p, c, x):
        cuts = []
        if ctx is not None:
            if kind == "shared_attn":
                return _decode_block(
                    cfg, kind, p, x, c, pos, memory,
                    fsdp_gather(shared, _block_specs(cfg, "attn")), rope,
                    plain=plain, block=block)
            p = fsdp_gather(p, _block_specs(cfg, kind))
            if kind in ("mamba", "mlstm", "slstm"):
                cuts = _state_cuts(ctx, cfg, kind, B)
        mine = c
        if cuts:
            c = dict(c, **{name: C.all_gather_cat(
                mine[name], ctx.model_group(), dim) for name, dim, _ in cuts})
        x = _decode_block(cfg, kind, p, x, c, pos, memory, shared, rope,
                          plain=plain, block=block)
        for name, dim, sl in cuts:
            mine[name].copy_(c[name].narrow(dim, sl.start,
                                            sl.stop - sl.start))
        return x

    for layer in range(n_groups):
        gp = _layer(params["blocks"], layer)
        gc = _layer(cache["blocks"], layer)
        for i, kind in enumerate(grp):
            if kind == "shared_attn":
                x = run(kind, None, _layer(cache["shared"]["attn"], layer), x)
            else:
                key = f"b{i}_{kind}"
                x = run(kind, gp[key], gc[key], x)
    for i, kind in enumerate(rem):
        key = f"t{i}_{kind}"
        x = run(kind, params["tail"][key], cache["tail"][key], x)
    logits = _logits(top, cfg, x, plain=plain)[:, 0]
    if batch_axes:
        logits = C.all_gather_cat(logits, ctx.mesh.group(batch_axes))
    return logits, cache


def _cache_block(ctx, cfg: ModelConfig, cache: dict, batch: int):
    """The ``KVBlock`` of the cache's KV leaves (the first found; every
    one has the same shape) for a batch of ``batch``; ``None`` for a
    cache without KV leaves (xlstm's)."""
    for key, t in tree_leaves(cache):
        if key.rsplit("/", 1)[-1] in ("k", "v"):
            return ctx.kv_block_of(batch, t.shape[-4:])
    return None


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
