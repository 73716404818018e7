"""Model configuration and parameter specs (port of ``repro.models.common``).

``ModelConfig`` is the reference dataclass field for field, so a config
written for the JAX package reads the same here.  Parameters are plain
trees (nested dicts of tensors) declared as ``ParamSpec`` leaves whose
``logical`` names resolve against an active sharding context
(``repro_torch.distributed``): ``sharding_tree`` gives each leaf's DTensor
placements, ``distribute_tree`` turns full tensors into ``DTensor``s built
from this rank's blocks, ``full_tree`` turns them back and ``local_tree``
takes each rank's block as a plain tensor (the sharded train step's
storage).  ``fsdp_gather`` turns a block of such blocks into what the
model computes with: each leaf's ``d`` dims that the rules store split
over data axes (FSDP) gathered whole, its tensor-parallel dims left as
this rank's block.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import FSDP_DIMS, active_ctx

__all__ = ["ModelConfig", "ParamSpec", "init_params", "spec_tree_num_params",
           "tree_leaves", "tree_map", "sharding_tree", "distribute_tree",
           "full_tree", "local_tree", "fsdp_gather"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    """One dataclass covers the whole assigned-architecture pool; families
    ignore the fields they don't use."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads

    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None   # sliding-window width (local layers)
    local_global_pattern: int = 0       # N local layers per 1 global (gemma3: 5)
    rope_theta: float = 10_000.0
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # mlp variants
    mlp_act: str = "swiglu"             # swiglu | relu2 | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0                  # mamba2 value heads
    ssm_conv: int = 4
    ssm_expand: int = 2
    hybrid_period: int = 0              # zamba2: shared attn every N mamba blocks
    slstm_every: int = 0                # xlstm: sLSTM every N blocks
    mlstm_proj_factor: float = 0.0      # xlstm: mLSTM pre-up-projection

    # encoder-decoder / VLM
    n_encoder_layers: int = 0
    cross_attn_period: int = 0          # llama-vision: 1 cross layer per N
    frontend_dim: int = 0               # stub frame/patch embedding dim

    tie_embeddings: bool = True
    embed_scale: float = 1.0            # gemma: sqrt(d_model)
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # training-time behavior
    remat: str = "full"                 # full | dots | none
    microbatches: int = 1               # gradient-accumulation splits
    # perf levers of the reference (defaults = baseline)
    norm_mult_dtype: str = "float32"    # "compute": f32 stats, bf16 multiply
    norm_custom_bwd: int = 0            # 1: hand-written bf16 rmsnorm VJP
    attn_probs_dtype: str = "float32"   # "compute": flash-style bf16 probs
    seq_shard_norms: int = 0            # 1: Megatron-SP norm/residual segs
    attn_block_remat: int = 0           # 1: checkpoint each q-block's attn
    loss_dtype: str = "float32"         # "compute": bf16 lse/onehot path

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]  # one logical name per dim
    init: str = "normal"                # normal | zeros | ones | scaled
    scale: float = 1.0                  # stddev (normal) / fan-in exponent

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def tree_leaves(tree: Any) -> list[tuple[str, Any]]:
    """``("/"-joined key, leaf)`` pairs of a nested-dict tree, keys sorted
    at every level — the order ``jax.tree_util`` flattens dicts in, so
    a checkpoint's manifest lists leaves identically from either
    package.  Empty dicts and ``None`` contribute no leaves, as in JAX."""
    out: list[tuple[str, Any]] = []
    _walk_leaves("", tree, out)
    return out


def _walk_leaves(prefix: str, node: Any, out: list) -> None:
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep ``out`` -- every leaf of the tree,
    # a whole train state on the card -- alive until the cycle collector
    # runs
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_leaves(f"{prefix}/{k}" if prefix else str(k), node[k], out)
    else:
        out.append((prefix, node))


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested-dict tree (and the leaves at
    the same keys of each tree in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _init_leaf(spec: ParamSpec, dtype: torch.dtype, device: torch.device,
               generator: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "scaled":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        std = spec.scale
    x = torch.randn(spec.shape, dtype=torch.float32, device=device,
                    generator=generator)
    # scaled in place: a leaf of billions of elements (one kimi-k2 expert
    # stack, 5.6 G) holds a single f32 draw at a time
    return x.mul_(std).to(dtype)


def init_params(specs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Any:
    """Materialize a spec tree into tensors, drawing leaves in sorted key
    order from ``generator`` (which must live on ``device``).  The
    numbers differ from ``jax.random``'s for the same seed; tests that
    compare the packages hand both the same numpy weights instead."""
    device = generator.device if device is None else torch.device(device)
    return tree_map(lambda s: _init_leaf(s, dtype, device, generator), specs)


def spec_tree_num_params(specs: Any) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(specs)))


def sharding_tree(specs: Any) -> Any:
    """Placements tree (requires an active ctx; divisibility-masked): each
    leaf's ``repro_torch.distributed.Placements``, one per mesh dim."""
    ctx = active_ctx()
    if ctx is None:
        raise RuntimeError("sharding_tree needs an active sharding context")
    return tree_map(lambda s: ctx.sharding(s.logical, s.shape), specs)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Full tensors -> ``DTensor``s: each rank keeps its block of each leaf
    (cut by the leaf's spec, ``Mesh.local_slices``) as the local shard.
    No collective runs; every rank must hold the same full values."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        if pl is None:
            return t
        local = t.detach()[pl.mesh.local_slices(pl.spec, t.shape)]
        return DTensor.from_local(local.contiguous(), pl.device_mesh,
                                  tuple(pl), run_check=False)

    return tree_map(one, tree, shardings)


def full_tree(tree: Any) -> Any:
    """``DTensor``s -> full tensors (``full_tensor()``: a collective);
    plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def local_tree(tree: Any) -> Any:
    """``DTensor``s -> this rank's local shards as plain tensors."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def fsdp_gather(tree: Any, specs: Any) -> Any:
    """``tree`` (this rank's blocks of leaves declared by ``specs``, whose
    ``layers`` dim, if any, is already sliced off) with every ``d`` dim
    (``FSDP_DIMS``) that the active rules store split over data axes
    all-gathered over them, in the order the rules name them (the first
    named major: ``("data", "pod")`` data-major, as the blocks are cut);
    the gradient of a gathered leaf is reduce-scattered back to the block
    (``collectives.gather_dim``).
    Without an active context, or with no such dim, the tree itself."""
    ctx = active_ctx()
    if ctx is None:
        return tree

    def one(t, s):
        for dim, axes in enumerate(ctx.layout(s.logical, s.shape)):
            if axes and s.logical[dim] in FSDP_DIMS:
                t = C.gather_dim(t, ctx.mesh.group(axes), dim)
        return t

    return tree_map(one, tree, specs)
