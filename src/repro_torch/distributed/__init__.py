"""Distribution (port of ``repro.distributed``): logical-axis rules resolved
against a ``torch.distributed`` device mesh, and the collectives the
expert-parallel MoE block differentiates through."""

from .context import (DEFAULT_RULES, KVBlock, Mesh, PartitionSpec, Placements,
                      ShardingCtx, ShardingRules, activate, active_ctx,
                      constrain, logical_to_spec, named_sharding,
                      process_index)

__all__ = ["DEFAULT_RULES", "KVBlock", "Mesh", "PartitionSpec", "Placements",
           "ShardingCtx", "ShardingRules", "activate", "active_ctx",
           "constrain", "logical_to_spec", "named_sharding",
           "process_index"]
