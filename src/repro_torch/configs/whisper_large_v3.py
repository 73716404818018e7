"""Whisper-large-v3 BACKBONE: enc-dec transformer [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280 20H (kv=20) d_ff=5120
vocab=51866, LayerNorm + GELU, no RoPE.  The conv/mel frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings [B, S, 1280]
(assignment note).  Decode cells exercise the decoder's self-attn cache
mechanically beyond whisper's semantic 448-token max (DESIGN.md §4).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    frontend_dim=1280,
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-reduced", n_layers=2, n_encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512, frontend_dim=64,
        remat="none",
    )
