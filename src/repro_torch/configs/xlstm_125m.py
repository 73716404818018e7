"""xLSTM-125M: alternating mLSTM / sLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H vocab=50304, d_ff=0 (the recurrent blocks carry their
own projections).  O(1)-state recurrence: runs the ``long_500k`` cell.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=2,
    mlstm_proj_factor=2.0,   # paper block: up-proj 2x, swish output gate
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=512, remat="none",
    )
