"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

* ``decode_attention`` replaces the TPU kernel
  ``repro/kernels/decode_attention/kernel.py:decode_attention_bkv``.
* ``rmsnorm`` replaces ``repro/kernels/rmsnorm/kernel.py:rmsnorm_rows``.

Dispatch rule of every wrapper: a CPU tensor goes to the plain version; a
CUDA tensor launches the kernel (built from ``repro_torch/csrc`` at first
use) or raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from .decode_attention import decode_attention, decode_attention_plain
from .rmsnorm import rmsnorm, rmsnorm_plain

__all__ = ["decode_attention", "decode_attention_plain", "rmsnorm",
           "rmsnorm_plain"]
