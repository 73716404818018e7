"""RMSNorm with an optional fused residual: CUDA kernel wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_rows``
(wrapper ``ops.py:rmsnorm``).  The kernel is ``repro_torch/csrc/rmsnorm.cu``:
memory-bound (each byte of x, residual and y crosses device memory once),
one warp per row up to d = 1024, one block per row above, 16-byte vector
loads, f32 statistics.  The port's decoder calls it without a residual,
as the reference model does; the residual form is the TPU kernel's and is
checked on the card all the same.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import library
from .._common import check_cuda, check_status, dtype_code, stream_handle

__all__ = ["rmsnorm", "rmsnorm_plain"]


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """``y = (x [+ r]) * rsqrt(mean((x [+ r])^2) + eps) * scale`` over the
    last dim, statistics and multiply in f32, y in x's dtype."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x ``[..., d]``, scale ``[d]``, residual like x -> y like x.

    CPU tensors take :func:`rmsnorm_plain`; CUDA tensors launch the kernel
    (counted in ``rmsnorm.launches``) or raise."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, residual, eps=eps)
    tensors = {"x": x, "scale": scale}
    if residual is not None:
        tensors["residual"] = residual
    dev = check_cuda("rmsnorm", **tensors)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} vs d={d}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("rmsnorm: residual must match x in shape and dtype")
    xc = dtype_code(x, "rmsnorm x")
    sc = dtype_code(scale, "rmsnorm scale")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    status = library().rmsnorm_launch(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), out.data_ptr(), rows, d, ctypes.c_float(eps), xc,
        sc, stream_handle(dev))
    check_status(status, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
