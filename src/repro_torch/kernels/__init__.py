"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

* ``decode_attention`` replaces the TPU kernel
  ``repro/kernels/decode_attention/kernel.py:decode_attention_bkv``;
  ``decode_attention_partials`` and ``decode_attention_merge`` are the
  same kernel's partials mode and its merge, for a cache split by
  sequence across ranks.
* ``rmsnorm`` replaces ``repro/kernels/rmsnorm/kernel.py:rmsnorm_rows``.
* ``flash_attention`` replaces
  ``repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``.
* ``ssm_scan`` replaces ``repro/kernels/ssm_scan/kernel.py:ssm_scan_bh``.

Dispatch rule of every wrapper: a CPU tensor goes to the plain version; a
CUDA tensor launches the kernel (built from ``repro_torch/csrc`` at first
use) or raises.  Each wrapper counts its launches in ``<wrapper>.launches``.

Gradients: every kernel is forward-only, as the TPU kernels are.  With
grad enabled and an input that requires it, ``rmsnorm``,
``flash_attention`` and ``ssm_scan`` launch inside an
``autograd.Function`` whose backward is the plain version's VJP
(recomputed; flash in blocks of queries); ``decode_attention``, which no
training path reaches, raises.  Without grad the launch runs bare.
"""

from .decode_attention import (decode_attention, decode_attention_merge,
                               decode_attention_merge_plain,
                               decode_attention_partials,
                               decode_attention_partials_plain,
                               decode_attention_plain,
                               decode_attention_splitk_plain, plan_splits)
from .flash_attention import flash_attention, flash_attention_plain
from .rmsnorm import plan_rows, rmsnorm, rmsnorm_lanes_plain, rmsnorm_plain
from .ssm_scan import plan_groups, ssm_scan, ssm_scan_plain

__all__ = ["decode_attention", "decode_attention_merge",
           "decode_attention_merge_plain", "decode_attention_partials",
           "decode_attention_partials_plain", "decode_attention_plain",
           "decode_attention_splitk_plain", "flash_attention",
           "flash_attention_plain", "plan_groups", "plan_rows", "plan_splits",
           "rmsnorm", "rmsnorm_lanes_plain", "rmsnorm_plain", "ssm_scan",
           "ssm_scan_plain"]
