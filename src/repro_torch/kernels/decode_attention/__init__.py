from .ops import (decode_attention, decode_attention_plain,
                  decode_attention_splitk_plain, plan_splits, split_bounds)

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_splitk_plain", "plan_splits", "split_bounds"]
