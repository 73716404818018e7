"""Zamba2-7B: Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 mamba2 blocks (d_model=3584, ssm_state=64, 112 SSD heads of 64) with a
SHARED attention+MLP block (32H kv=32, head_dim 112, d_ff=14336) applied
every 6 blocks: 13 applications of the same weights, run as groups of
(6 mamba + shared attn) with a 3-mamba tail.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    hybrid_period=6,
    mlp_act="gelu",
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-reduced", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, ssm_state=16,
        hybrid_period=2, remat="none",
    )
