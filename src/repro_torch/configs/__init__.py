"""Architecture registry of the port: one module per ported architecture.

``get_config(name)`` returns the full (paper-table) config; every module
also exposes ``reduced()``, a family-preserving miniature for CPU tests.
The registry equals the reference's (``repro.configs``): the dense
family (qwen2.5-14b, qwen3-1.7b, nemotron-4-15b, gemma3-1b with its 5:1
local/global program), the hybrid zamba2-7b, the MoE olmoe-1b-7b and
kimi-k2-1t-a32b, the xLSTM xlstm-125m (ssm), the encoder-decoder
whisper-large-v3 (encdec) and the cross-attention llama-3.2-vision-11b
(vlm).
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "kimi_k2_1t_a32b",
    "olmoe_1b_7b",
    "qwen2_5_14b",
    "qwen3_1_7b",
    "nemotron_4_15b",
    "gemma3_1b",
    "whisper_large_v3",
    "zamba2_7b",
    "llama3_2_vision_11b",
    "xlstm_125m",
]

#: CLI names (--arch) -> module names
ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma3-1b": "gemma3_1b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "xlstm-125m": "xlstm_125m",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()


def list_archs() -> list[str]:
    return list(ALIASES)
