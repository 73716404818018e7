"""Decode attention (one new token against the KV cache, GQA): CUDA kernel
wrapper and its plain PyTorch version.

Replaces the TPU kernel
``src/repro/kernels/decode_attention/kernel.py:decode_attention_bkv``
(wrapper ``ops.py:decode_attention``).  The kernel is
``repro_torch/csrc/decode_attention.cu``: memory-bound (it streams the
valid keys and values of the cache once), f32 online softmax over keys
``max(0, pos - window + 1) .. pos`` only.  The grid is (batch x kv head,
``n_split``): each block walks one slice of the key range and, above one
slice, a merge launch combines the slices (flash-decoding).
:func:`plan_splits` picks ``n_split`` on the host from the cache length,
never from ``pos``.  The TPU wrapper's transposes and padding (hd to 128
lanes, S to the block) are layout choices of that chip: the kernel reads
the model's ``[B, S_max, KV, hd]`` caches directly and masks nothing it
does not read.

``pos`` is a one-element int32 tensor on the caches' device, read by the
kernel itself, so a decode step never waits on the host.

**Partials mode**, for a cache split by sequence across ranks (decode
under a mesh): :func:`decode_attention_partials` runs the same kernel over
one rank's block of keys, which starts at global key ``k_off``, with the
position ``pos - k_off`` formed on the device, and returns each slice's
f32 ``(m, l, acc)`` instead of the output (at one slice too, with no merge
launch); the ranks all-gather those buffers and
:func:`decode_attention_merge` runs the kernel's merge over every rank's
slices.  A block wholly past ``pos`` (or before the window) gives empty
partials (m = -inf, l = 0), which weigh nothing in the merge.  The plain
versions, :func:`decode_attention_partials_plain` and
:func:`decode_attention_merge_plain`, compute the slices as
:func:`decode_attention_splitk_plain` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import library
from .._common import (check_cuda, check_status, dtype_code, sm_count,
                       stream_handle)

__all__ = ["blocks_per_sm", "decode_attention", "decode_attention_merge",
           "decode_attention_merge_plain", "decode_attention_partials",
           "decode_attention_partials_plain", "decode_attention_plain",
           "decode_attention_splitk_plain", "plan_splits", "split_bounds"]

#: masked-score constant of the reference oracle (``ref.py``)
_NEG_INF = -1e30
#: head dims the kernel is instantiated for, and the largest GQA group of
#: each (hd 256 holds 8 dims of every row in a lane's registers: up to 4)
HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = {64: 16, 112: 16, 128: 16, 256: 4}
#: keys per tile of the kernel, and the fewest keys a slice of the key
#: range is given before it pays to split further
TILE_KEYS = 32
MIN_SPLIT_KEYS = 256
#: the most blocks per SM the split aims for (four 48 KB bf16 blocks at hd
#: 128 share an SM), the shared memory of an SM, and what each block needs
#: beside its ring (its static p / m / l / alpha arrays, the runtime's 1 KB)
BLOCKS_PER_SM = 4
SMEM_PER_SM = 228 * 1024
SMEM_BESIDE_RING = 3 * 1024


def ring_bytes(hd: int, itemsize: int) -> int:
    """The kernel's K + V ring (``smem_bytes`` in the source): 3 stages of
    32-key tiles at bf16, 2 at f32."""
    stages = 3 if itemsize == 2 else 2
    return stages * 2 * TILE_KEYS * hd * itemsize


def blocks_per_sm(hd: int, itemsize: int) -> int:
    """Blocks of the instance for ``hd`` and ``itemsize`` that one SM holds
    at once: as many rings as its shared memory takes, at most
    ``BLOCKS_PER_SM`` (4 at bf16 hd 128, 2 at bf16 hd 256, 1 at f32 hd
    256)."""
    per = ring_bytes(hd, itemsize) + SMEM_BESIDE_RING
    return max(1, min(BLOCKS_PER_SM, SMEM_PER_SM // per))


def plan_splits(s_max: int, bkv: int, sms: int, *, hd: int = 128,
                itemsize: int = 2) -> int:
    """Slices of the key range for a cache of ``s_max`` keys, ``bkv``
    (batch x kv head) rows and a card of ``sms`` SMs: as many as fit in one
    wave of the :func:`blocks_per_sm` blocks of the ``hd`` / ``itemsize``
    instance on every SM (a second, partial wave would double the time),
    each slice at least ``MIN_SPLIT_KEYS`` keys long.  1 for a short
    serving cache, where the kernel writes the output itself with no merge
    launch."""
    want = blocks_per_sm(hd, itemsize) * sms // max(bkv, 1)
    return max(1, min(want, -(-s_max // MIN_SPLIT_KEYS)))


def split_bounds(pos: int, s_max: int, n_split: int,
                 window: Optional[int] = None) -> list[tuple[int, int]]:
    """The kernel's slices ``[lo, hi]`` (inclusive; ``lo > hi`` when empty):
    slice ``s`` is cache keys ``[s * per, (s + 1) * per)``, ``per`` being
    ``s_max / n_split`` in whole ``TILE_KEYS`` tiles, cut to the valid keys
    ``max(0, pos - window + 1) .. min(pos, s_max - 1)``, as each block
    computes it on the device from ``pos``."""
    per = -(-s_max // n_split)                      # keys per slice ...
    per = -(-per // TILE_KEYS) * TILE_KEYS          # ... in whole tiles
    hi = min(pos, s_max - 1)
    lo = max(0, pos - window + 1) if window is not None else 0
    return [(max(lo, s * per), min(hi, s * per + per - 1))
            for s in range(n_split)]


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


def _slice_partials(qf: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, bounds: list, scale: float):
    """Each slice ``[lo, hi]`` of ``bounds``: its max m ``[B, KV, G]``, its
    sum l and its unnormalised f32 accumulator ``[B, KV, G, hd]`` (m =
    -inf, l = 0, acc = 0 for an empty slice), as the kernel's blocks
    compute them."""
    B, KV, G, hd = qf.shape
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        if lo > hi:
            ms.append(torch.full((B, KV, G), -math.inf, device=qf.device))
            ls.append(torch.zeros((B, KV, G), device=qf.device))
            accs.append(torch.zeros((B, KV, G, hd), device=qf.device))
            continue
        s = torch.einsum("bkgh,bskh->bkgs", qf,
                         k_cache[:, lo:hi + 1].float()) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskh->bkgh", p,
                                 v_cache[:, lo:hi + 1].float()))
    return ms, ls, accs


def decode_attention_splitk_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, pos: torch.Tensor, *,
                                  n_split: int,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """The kernel's split-and-merge arithmetic in plain PyTorch (tests
    only): each slice of :func:`split_bounds` gives its max m, its sum l
    and its unnormalised f32 accumulator; an empty slice gives m = -inf,
    l = 0; the merge weighs each slice by e^(m - max m).  Same contract as
    :func:`decode_attention_plain`."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qf = q[:, 0].float().reshape(B, KV, G, hd)
    ms, ls, accs = _slice_partials(
        qf, k_cache, v_cache, split_bounds(int(pos), S, n_split, window),
        scale)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0)).nan_to_num_(0.0)      # empty slices weigh 0
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[
        ..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partials_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                    v_cache: torch.Tensor, pos: torch.Tensor,
                                    *, k_off: int = 0, n_split: int = 1,
                                    scale: Optional[float] = None,
                                    window: Optional[int] = None
                                    ) -> torch.Tensor:
    """The partials of a block of keys in plain PyTorch.  q ``[B, 1, H,
    hd]``; caches ``[B, S, KV, hd]`` holding keys ``k_off .. k_off + S -
    1`` of the whole cache; pos the global position (an int32 scalar
    tensor; read on the host).  Each of the ``n_split`` slices of
    :func:`split_bounds` at ``pos - k_off`` gives m, l and acc as
    :func:`decode_attention_splitk_plain` computes them; returns the flat
    f32 buffer laid out as the kernel writes its scratch: m ``[B KV, n,
    G]``, l ``[B KV, n, G]``, then acc ``[B KV, n, G, hd]``."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qf = q[:, 0].float().reshape(B, KV, G, hd)
    ms, ls, accs = _slice_partials(
        qf, k_cache, v_cache,
        split_bounds(int(pos) - k_off, S, n_split, window), scale)
    return torch.cat([torch.stack(ms, dim=2).reshape(-1),
                      torch.stack(ls, dim=2).reshape(-1),
                      torch.stack(accs, dim=2).reshape(-1)])


def decode_attention_merge_plain(parts: torch.Tensor, q: torch.Tensor,
                                 kv_heads: int) -> torch.Tensor:
    """The merge of R blocks' partials ``parts`` ``[R, N]`` (in the order
    of the blocks' keys) for queries shaped like ``q`` ``[B, 1, H, hd]``:
    each slice weighed by e^(m - max m), empty slices by 0, the output in
    q's dtype."""
    B, _, H, hd = q.shape
    G, bkv, R = H // kv_heads, B * kv_heads, parts.shape[0]
    n = parts.shape[1] // (bkv * G * (hd + 2))
    mg = bkv * n * G
    # every block's slices side by side: [bkv, R n, G] (acc [..., hd])
    m = parts[:, :mg].reshape(R, bkv, n, G).transpose(0, 1).reshape(
        bkv, R * n, G)
    l = parts[:, mg:2 * mg].reshape(R, bkv, n, G).transpose(0, 1).reshape(
        bkv, R * n, G)
    acc = parts[:, 2 * mg:].reshape(R, bkv, n, G, hd).transpose(0, 1).reshape(
        bkv, R * n, G, hd)
    w = torch.exp(m - m.amax(1, keepdim=True)).nan_to_num_(0.0)
    out = (acc * w[..., None]).sum(1) / (l * w).sum(1).clamp_min(1e-30)[
        ..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _check(name: str, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, pos, window: Optional[int]):
    """The kernel's conditions on a CUDA call; its device."""
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        # no training path reaches this kernel, and it has no backward
        raise RuntimeError(f"{name}: the kernel is forward-only; "
                           f"call it with grad disabled or with inputs that "
                           f"do not require grad")
    if not isinstance(pos, torch.Tensor):
        raise TypeError(f"{name}: pos must be an int32 tensor on "
                        f"the device")
    dev = check_cuda(name, q=q, k_cache=k_cache, v_cache=v_cache, pos=pos)
    B, one, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, S, KV, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: hd={hd} not in {HEAD_DIMS}")
    if H % KV or not 1 <= H // KV <= MAX_GROUP[hd]:
        raise ValueError(f"{name}: H={H}, KV={KV} (group must "
                         f"divide and be <= {MAX_GROUP[hd]} at hd {hd})")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q and caches must share a dtype")
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError(f"{name}: pos must be one int32")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window={window}")
    for arg, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte "
                             f"aligned")
    return dev


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`decode_attention_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``decode_attention.launches``, once per call, merge launch
    included) or raise.  The kernel has no backward: with grad enabled and
    an input that requires it, a CUDA call raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, scale=scale,
                                      window=window)
    dev = _check("decode_attention", q, k_cache, v_cache, pos, window)
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    code = dtype_code(q, "decode_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    n_split = plan_splits(S, B * KV, sm_count(dev.index or 0), hd=hd,
                          itemsize=q.element_size())
    scratch = None
    if n_split > 1:     # m, l and the f32 accumulator of every slice
        scratch = torch.empty(B * KV * n_split * (H // KV) * (hd + 2),
                              dtype=torch.float32, device=dev)
    status = library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), B, S,
        KV, H // KV, hd, ctypes.c_float(scale), window or 0, n_split, code,
        stream_handle(dev))
    check_status(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: torch.Tensor, *,
                              k_off: int = 0, scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """The partials of one block of a cache split by sequence: caches
    ``[B, S, KV, hd]`` holding keys ``k_off .. k_off + S - 1``, pos the
    global position (an int32 tensor on the device) -> the flat f32 buffer
    of every slice's ``(m, l, acc)`` (the kernel's scratch layout), for
    :func:`decode_attention_merge` after the ranks' all-gather.

    CPU tensors take :func:`decode_attention_partials_plain` (one slice);
    CUDA tensors launch the kernel in its partials mode, ``plan_splits``
    slices and no merge (counted in ``decode_attention_partials.launches``)
    or raise.  ``pos - k_off`` is formed on the device, so the call never
    waits on the host and can be captured."""
    if q.device.type == "cpu":
        return decode_attention_partials_plain(
            q, k_cache, v_cache, pos, k_off=k_off, scale=scale, window=window)
    dev = _check("decode_attention_partials", q, k_cache, v_cache, pos,
                 window)
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    code = dtype_code(q, "decode_attention_partials")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    local = pos - k_off if k_off else pos        # on the device
    n_split = plan_splits(S, B * KV, sm_count(dev.index or 0), hd=hd,
                          itemsize=q.element_size())
    parts = torch.empty(B * KV * n_split * (H // KV) * (hd + 2),
                        dtype=torch.float32, device=dev)
    status = library().decode_attention_partials_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        local.data_ptr(), parts.data_ptr(), B, S, KV, H // KV, hd,
        ctypes.c_float(scale), window or 0, n_split, code, stream_handle(dev))
    check_status(status, "decode_attention_partials")
    decode_attention_partials.launches += 1
    return parts


decode_attention_partials.launches = 0


def decode_attention_merge(parts: torch.Tensor, q: torch.Tensor,
                           kv_heads: int) -> torch.Tensor:
    """The output ``[B, 1, H, hd]`` (q's shape and dtype) of R blocks'
    partials ``parts`` ``[R, N]``, in the order of the blocks' keys (the
    all-gather over the cache's sequence group).

    CPU tensors take :func:`decode_attention_merge_plain`; CUDA tensors
    launch the kernel's merge, which reads every block's slices in place
    in ``parts`` (counted in ``decode_attention_merge.launches``), or
    raise."""
    if parts.device.type == "cpu":
        return decode_attention_merge_plain(parts, q, kv_heads)
    dev = check_cuda("decode_attention_merge", parts=parts)
    B, one, H, hd = q.shape
    if one != 1 or H % kv_heads or parts.dim() != 2 \
            or parts.dtype != torch.float32 or not parts.is_contiguous():
        raise ValueError(f"decode_attention_merge: q {tuple(q.shape)}, "
                         f"{kv_heads} KV heads, partials "
                         f"{tuple(parts.shape)} {parts.dtype}")
    G, bkv = H // kv_heads, B * kv_heads
    if parts.shape[1] % (bkv * G * (hd + 2)):
        raise ValueError(f"decode_attention_merge: {parts.shape[1]} floats "
                         f"a block is not whole slices of {bkv} x {G} x "
                         f"{hd + 2}")
    R, N = parts.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    status = library().decode_attention_merge_launch(
        parts.data_ptr(), out.data_ptr(), bkv, R, N,
        N // (bkv * G * (hd + 2)), G, hd,
        dtype_code(q, "decode_attention_merge"), stream_handle(dev))
    check_status(status, "decode_attention_merge")
    decode_attention_merge.launches += 1
    return out


decode_attention_merge.launches = 0
