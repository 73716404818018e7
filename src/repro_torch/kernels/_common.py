"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import functools
from typing import Union

import torch

#: dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: Union[torch.Tensor, torch.dtype], what: str) -> int:
    dtype = t if isinstance(t, torch.dtype) else t.dtype
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{what}: unsupported dtype {dtype} "
                        f"(kernel takes {sorted(map(str, DTYPE_CODES))})")
    return code


def check_cuda(what: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous; returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {dev}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev


def check_status(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{code}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
