"""Architecture registry of the port: one module per ported architecture.

``get_config(name)`` returns the full (paper-table) config; every module
also exposes ``reduced()``, a family-preserving miniature for CPU tests.
Architectures join as their slice is ported; the reference registry is
``repro.configs``.  Ported: the dense family (qwen2.5-14b, qwen3-1.7b,
nemotron-4-15b, gemma3-1b with its 5:1 local/global program) and the
hybrid zamba2-7b.  Still to come: olmoe and kimi-k2 (moe), xlstm (ssm),
whisper (encdec) and llama-3.2-vision (vlm).
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = ["qwen2_5_14b", "qwen3_1_7b", "nemotron_4_15b", "gemma3_1b",
            "zamba2_7b"]

#: CLI names (--arch) -> module names
ALIASES = {"qwen2.5-14b": "qwen2_5_14b", "qwen3-1.7b": "qwen3_1_7b",
           "nemotron-4-15b": "nemotron_4_15b", "gemma3-1b": "gemma3_1b",
           "zamba2-7b": "zamba2_7b"}


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
