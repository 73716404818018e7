"""Sharding rules of the production launch (port of the rules in
``repro.launch.dryrun``).

``rules_for`` gives an architecture's compute and storage rules,
``opt_rules_for`` the optimizer moments' (ZeRO-1: the moments split over
the data axes on their ``d`` dims) and ``decode_rules`` the decode cache's.
The functions and ``_FSDP_ARCHS`` are copies of the reference's, with
the imports rewritten to the port's ``ShardingRules`` and ``ModelConfig``.
``serve_rules`` composes them for a decode cell as the reference's
``run_cell`` does.

The rest of the reference's module -- the cell accounting (``run_cell``,
``main``), the HLO walk and the TPU roofline constants -- is not ported
yet: it waits for the port's shape and cost tooling (ROADMAP Queue 1).
"""

from repro_torch.distributed.context import Mesh, ShardingRules
from repro_torch.models.common import ModelConfig

__all__ = ["rules_for", "opt_rules_for", "decode_rules", "serve_rules"]


#: archs whose attention heads don't tile the 16-way model axis (40H, 20H,
#: or big replicated wk/wv) — their params take FSDP storage over 'data'
#: via the embed dim instead (gathered per layer by SPMD; overlappable).
_FSDP_ARCHS = ("qwen2.5-14b", "whisper-large-v3", "kimi-k2-1t-a32b")


def rules_for(cfg: ModelConfig, multi_pod: bool, fsdp_scope: str = "all",
              pp: bool = False):
    """(compute_rules, storage_rules) per arch.

    Compute rules steer the model's layout of its intermediates; storage
    rules resolve the parameters' blocks, which must tile evenly --
    divisibility masking in ``ShardingCtx.spec`` drops what doesn't fit,
    and FSDP archs shard the d dims over the data axes instead.
    ``fsdp_scope``: "all" (embed + attention + mlp d dims) or "attn"
    (attention weights only -- the MLP keeps pure-TP storage).
    """
    rules = ShardingRules()
    # with pipeline parallelism the pod axis holds STAGES, not data
    data_axes = ("data", "pod") if (multi_pod and not pp) else ("data",)
    if pp:
        rules = rules.override(layers="pod")
    if getattr(cfg, "seq_shard_norms", 0):
        rules = rules.override(seq_sp="model")
    if cfg.family == "moe":
        # expert weights: FSDP storage over data axes, gathered inside the
        # MoE shard_map (its AD transpose reduce-scatters the grads).
        rules = rules.override(expert_mlp=data_axes)
    if cfg.name.startswith("gemma3") or cfg.name.startswith("xlstm"):
        # 4 q-heads / <=4 kv-heads cannot shard 16-way; attention stays
        # replicated over 'model' and the MLP carries the TP.
        rules = rules.override(qheads=None, kv_heads=None)
    storage = rules
    if cfg.name in _FSDP_ARCHS:
        fsdp = dict(attn_in=data_axes, attn_out_d=data_axes)
        if fsdp_scope == "all":
            fsdp["embed"] = data_axes
        storage = rules.override(**fsdp)
    return rules, storage


def opt_rules_for(storage: ShardingRules, multi_pod: bool) -> ShardingRules:
    """ZeRO-1: moments additionally sharded over the data axes via the
    d dims (divisible by 32 for every assigned arch)."""
    data_axes = ("data", "pod") if multi_pod else ("data",)
    return storage.override(embed=data_axes, attn_in=data_axes,
                            attn_out_d=data_axes)


def decode_rules(cfg: ModelConfig, rules: ShardingRules,
                 batch: int, model_axis: int = 16) -> ShardingRules:
    """Decode-cache sharding strategy.

    * batch==1 (long_500k): seq-shard the cache over 'data' (batch can't
      shard; masking would otherwise leave the 500k cache replicated).
    * kv-heads divide the model axis: keep head-sharded caches.
    * otherwise (GQA kv=8 vs model=16): seq-shard the cache over 'model'.
    """
    if batch <= 8:
        if cfg.n_kv_heads % model_axis == 0:
            return rules.override(cache_seq="data")
        return rules.override(cache_seq=("data", "model"), kv_heads=None)
    if cfg.n_kv_heads % model_axis != 0:
        return rules.override(cache_seq="model", kv_heads=None)
    return rules


def serve_rules(cfg: ModelConfig, mesh, batch: int,
                multi_pod: bool = False) -> ShardingRules:
    """The rules of a decode cell on ``mesh`` (a ``Mesh`` or a
    ``DeviceMesh`` with named dims) at batch ``batch``, as the reference's
    ``run_cell`` composes them: the parameters under the storage rules of
    ``rules_for``, the cache and the step under ``decode_rules`` of its
    compute rules with the mesh's ``model`` size.  One rules object holds
    both, ``decode_rules`` applied to the storage rules: the two differ
    only in the FSDP ``d`` dims (storage) and in ``cache_seq`` /
    ``kv_heads`` (decode), and ``kv_heads=None`` is set only where the
    model size does not divide the KV heads, where the storage spec masks
    ``wk`` / ``wv`` to replicated already.  Activate it for
    ``restore_checkpoint(shardings=...)``, ``init_cache`` and the decode
    step alike."""
    from repro_torch.distributed.context import Mesh

    _, storage = rules_for(cfg, multi_pod)
    return decode_rules(cfg, storage, batch,
                        model_axis=Mesh.of(mesh).shape.get("model", 1))
