"""Kimi K2: trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840.
~1.03T total params, ~32B active.  Trains with full remat, FSDP expert
storage (see sharding overrides in launch/dryrun.py) and gradient
accumulation — the dispatch buffers at 1M-token global batch demand
microbatching (DESIGN.md §4).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    capacity_factor=1.25,
    mlp_act="swiglu",
    tie_embeddings=True,
    remat="full",
    microbatches=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=8, top_k=2,
        microbatches=1, remat="none",
    )
