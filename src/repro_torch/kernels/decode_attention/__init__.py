from .ops import decode_attention, decode_attention_plain

__all__ = ["decode_attention", "decode_attention_plain"]
