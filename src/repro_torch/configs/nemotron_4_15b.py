"""Nemotron-4-15B: dense, GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="relu2",
    tie_embeddings=False,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=512, remat="none",
    )
