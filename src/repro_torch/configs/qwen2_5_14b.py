"""Qwen2.5-14B: dense, GQA kv=8, QKV bias [hf:Qwen/Qwen2.5].

48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    tie_embeddings=False,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2.5-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, remat="none",
    )
