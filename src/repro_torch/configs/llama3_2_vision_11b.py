"""Llama-3.2-11B-Vision BACKBONE: cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256; every 5th layer is a
gated cross-attention layer over vision patch embeddings.  The vision tower
is a STUB: ``input_specs()`` supplies precomputed patch embeddings.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    frontend_dim=1280,
    rope_theta=500_000.0,
    mlp_act="swiglu",
    tie_embeddings=False,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama-vision-reduced", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, frontend_dim=32,
        remat="none",
    )
