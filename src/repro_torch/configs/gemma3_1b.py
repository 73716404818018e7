"""Gemma3-1B: 5:1 local:global attention, kv=1, 128k ctx [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding window 512 on local layers, qk-norm, sqrt(d) embedding scale.
The 5:1 sliding-window majority is why gemma3 runs the ``long_500k`` cell
(DESIGN.md §4).
"""

import math

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    qk_norm=True,
    attn_window=512,
    local_global_pattern=5,
    rope_theta=1_000_000.0,
    mlp_act="gelu",
    tie_embeddings=True,
    embed_scale=math.sqrt(1152.0),
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-reduced", n_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=16, attn_window=16,
        embed_scale=8.0, remat="none",
    )
