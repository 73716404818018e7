"""Assigned input-shape cells and per-arch applicability (port of
``repro.configs.shapes``).

Four cells per LM arch (assignment):
  train_4k     seq=4096   global_batch=256   (train_step)
  prefill_32k  seq=32768  global_batch=32    (prefill forward)
  decode_32k   seq=32768  global_batch=128   (serve_step: 1 token, 32k cache)
  long_500k    seq=524288 global_batch=1     (serve_step; sub-quadratic only)

``long_500k`` is skipped for pure full-attention archs (a 500k dense cache/
prefill is the quadratic case the cell excludes) and runs for the
SSM/hybrid/sliding-window archs: zamba2, xlstm, gemma3.

The reference's stand-ins are ``jax.ShapeDtypeStruct``s carrying their
``NamedSharding``.  Here they are ``device="meta"`` tensors of the global
shapes and dtypes (no memory behind them).  Each carries ``logical``, its
logical axis names, and ``sharding``: under an active ``ShardingCtx``
the ``Placements`` of its divisibility-masked spec (``ShardingCtx.
sharding``), else ``None``.  This rank's block of one is
``ShardingCtx.block(t.logical, t.shape)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.distributed.context import active_ctx
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import _CACHE_F32, cache_specs

__all__ = ["ShapeCell", "SHAPES", "applicable", "train_inputs",
           "serve_inputs", "WHISPER_MEMORY_LEN", "VLM_PATCHES"]

WHISPER_MEMORY_LEN = 1500   # whisper's native 30 s encoder grid
VLM_PATCHES = 1024          # stub patch count for the vision stream


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

#: archs allowed to run long_500k (sub-quadratic serving path)
_LONG_OK_FAMILIES = ("hybrid", "ssm")


def applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    if shape.name == "long_500k":
        if cfg.family in _LONG_OK_FAMILIES:
            return True, "sub-quadratic (SSM/hybrid)"
        if cfg.local_global_pattern:
            return True, "sliding-window majority (5:1 local:global)"
        return False, ("skipped: pure full-attention arch; 500k dense "
                       "attention is the quadratic case this cell excludes")
    return True, "ok"


def _sds(shape: Sequence[int], dtype: torch.dtype,
         logical: Sequence[Optional[str]]) -> torch.Tensor:
    """A meta tensor of the global ``shape``, with its logical axes and,
    under an active context, its placements."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    ctx = active_ctx()
    t.logical = tuple(logical)
    t.sharding = ctx.sharding(logical, tuple(shape)) if ctx else None
    return t


def train_inputs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Meta-tensor stand-ins for one global batch (train or prefill)."""
    B, S = shape.batch, shape.seq
    batch = {"tokens": _sds((B, S), torch.int32, ("batch", "seq"))}
    if cfg.family == "encdec":
        # seq applies to the encoder's frame axis (the long dim in audio);
        # decoder tokens cap at whisper's semantic max.
        batch["frames"] = _sds((B, S, cfg.frontend_dim), torch.bfloat16,
                               ("batch", "seq", None))
        batch["tokens"] = _sds((B, min(S, 448)), torch.int32, ("batch", None))
    elif cfg.family == "vlm":
        batch["patches"] = _sds((B, VLM_PATCHES, cfg.frontend_dim),
                                torch.bfloat16, ("batch", "frames", None))
    return batch


def _cache_tree(cfg: ModelConfig, node: dict) -> dict:
    """The cache spec tree as stand-ins: recurrent states (``_CACHE_F32``)
    in f32, every other leaf in the compute dtype."""
    return {name: _cache_tree(cfg, leaf) if isinstance(leaf, dict) else
            _sds(leaf.shape, torch.float32 if name in _CACHE_F32
                 else cfg.torch_dtype, leaf.logical)
            for name, leaf in node.items()}


def serve_inputs(cfg: ModelConfig, shape: ShapeCell):
    """(cache, token, pos) stand-ins for one decode step."""
    B, S = shape.batch, shape.seq
    mem_len = 0
    if cfg.family == "encdec":
        mem_len = WHISPER_MEMORY_LEN
    elif cfg.family == "vlm":
        mem_len = VLM_PATCHES
    cache = _cache_tree(cfg, cache_specs(cfg, B, S, mem_len))
    token = _sds((B, 1), torch.int32, ("batch", None))
    pos = torch.empty((), dtype=torch.int32, device="meta")
    pos.logical, pos.sharding = (), None
    return cache, token, pos
