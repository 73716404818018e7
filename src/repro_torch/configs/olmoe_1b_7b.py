"""OLMoE-1B-7B: 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    capacity_factor=1.25,
    mlp_act="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="olmoe-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=512, n_experts=8, top_k=2, remat="none",
    )
