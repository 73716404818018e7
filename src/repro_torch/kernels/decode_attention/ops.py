"""Decode attention (one new token against the KV cache, GQA): CUDA kernel
wrapper and its plain PyTorch version.

Replaces the TPU kernel
``src/repro/kernels/decode_attention/kernel.py:decode_attention_bkv``
(wrapper ``ops.py:decode_attention``).  The kernel is
``repro_torch/csrc/decode_attention.cu``: memory-bound (it streams the
valid keys and values of the cache once), one block per (batch, kv head)
walking only keys ``max(0, pos - window + 1) .. pos``, f32 online softmax.
The TPU wrapper's transposes and padding (hd to 128 lanes, S to the block)
are layout choices of that chip: the kernel reads the model's
``[B, S_max, KV, hd]`` caches directly and masks nothing it does not read.

``pos`` is a one-element int32 tensor on the caches' device, read by the
kernel itself, so a decode step never waits on the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import library
from .._common import check_cuda, check_status, dtype_code, stream_handle

__all__ = ["decode_attention", "decode_attention_plain"]

#: masked-score constant of the reference oracle (``ref.py``)
_NEG_INF = -1e30
#: head dims the kernel is instantiated for, and the largest GQA group
HEAD_DIMS = (64, 112, 128)
MAX_GROUP = 16


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """q ``[B, 1, H, hd]``; caches ``[B, S_max, KV, hd]``; pos int32 scalar
    tensor -> ``[B, 1, H, hd]`` in q's dtype.  Keys ``j <= pos`` (and
    ``j > pos - window``) take part; scores, softmax and the PV product
    are f32."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qf = q[:, 0].float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (kpos > pos - window)
    s = s.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`decode_attention_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``decode_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, scale=scale,
                                      window=window)
    if not isinstance(pos, torch.Tensor):
        raise TypeError("decode_attention: pos must be an int32 tensor on "
                        "the device")
    dev = check_cuda("decode_attention", q=q, k_cache=k_cache,
                     v_cache=v_cache, pos=pos)
    B, one, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, S, KV, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if H % KV or not 1 <= H // KV <= MAX_GROUP:
        raise ValueError(f"decode_attention: H={H}, KV={KV} (group must "
                         f"divide and be <= {MAX_GROUP})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: hd={hd} not in {HEAD_DIMS}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q and caches must share a dtype")
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError("decode_attention: pos must be one int32")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window={window}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             f"aligned")
    code = dtype_code(q, "decode_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    status = library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, KV, H // KV, hd, ctypes.c_float(scale),
        window or 0, code, stream_handle(dev))
    check_status(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
