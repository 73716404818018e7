"""Qwen3-1.7B: dense, qk-norm, GQA [hf:Qwen/Qwen3].

28L d_model=2048 16H (kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, remat="none",
    )
