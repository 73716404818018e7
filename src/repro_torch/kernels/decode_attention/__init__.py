from .ops import (decode_attention, decode_attention_merge,
                  decode_attention_merge_plain, decode_attention_partials,
                  decode_attention_partials_plain, decode_attention_plain,
                  decode_attention_splitk_plain, plan_splits, split_bounds)

__all__ = ["decode_attention", "decode_attention_merge",
           "decode_attention_merge_plain", "decode_attention_partials",
           "decode_attention_partials_plain", "decode_attention_plain",
           "decode_attention_splitk_plain", "plan_splits", "split_bounds"]
