from .ops import (FlashAttentionFn, flash_attention, flash_attention_plain,
                  flash_attention_vjp)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_plain",
           "flash_attention_vjp"]
