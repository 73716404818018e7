"""Full-sequence attention (prefill / forward, GQA, causal and sliding
window): CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``
(wrapper ``ops.py:flash_attention``).  The kernel is
``repro_torch/csrc/flash_attention.cu``.  At bf16 it runs on the tensor
cores: one block per (batch, query head, 128-query tile) walks its
reachable 128-key tiles (64-key at hd 256, so that Q and two stages of K
and V fit in shared memory), a producer warp loads Q, K and V tiles by TMA
into a ring of shared-memory stages, and two warpgroups run ``wgmma`` for
S = QK^T and O += PV with the f32 online softmax in registers; P is
rounded to bf16 before PV.  At f32 (``wgmma`` has no f32 inputs) it runs a
scalar kernel with f32 probabilities.  Tiles wholly above the diagonal or
left of the window are never loaded.  It reads the model's
``[B, S, N, hd]`` layout directly: the TPU wrapper's transposes, its
padding of hd to 128 lanes and of S to the block are layout choices of
that chip; a ragged ``Sk`` is masked by the kernel itself.

Query ``i`` and key ``j`` sit at positions ``i`` and ``j`` (both from 0,
as in the TPU kernel).  A row whose every key is masked gives 0.

``probs="compute"`` is the model's ``attn_probs_dtype="compute"``
lever (the reference's ``_sdpa(..., probs_dtype="compute")``,
``src/repro/models/layers.py:228-254``): the scaled scores are rounded to
the compute dtype, ``p = exp(s - m)`` is kept in it, the PV product is
unnormalised and the row sums of the rounded ``p`` are taken in f32,
with the normalisation after PV.  The bf16 kernel runs it as an instance
of the same template (``kCompute``): each scaled score is rounded to bf16
as the reference rounds ``q.k`` and then ``* scale``, and the row sum
adds the bf16-rounded P that the PV product reads.  Two deliberate
differences from the plain version remain: the kernel's max is a running
max with rescaling, where the plain version subtracts the row's final
max, and it normalises ``o`` in f32 before its single rounding, where
the plain version rounds the PV product and then multiplies by the
rounded inverse.  At f32 both modes are the same function, and the same
launch serves both.

Gradients: the TPU kernel is forward-only, and so is this one.  Under
autograd the launch runs inside :class:`FlashAttentionFn`, whose backward
recomputes the plain version in blocks of queries and differentiates it
(:func:`flash_attention_vjp`, in the same ``probs`` mode); at bf16 that
is the VJP of the plain function at the kernel's inputs, which in the
float32 mode keeps P in f32 where the kernel rounds it to bf16.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import library
from .._common import check_cuda, check_status, dtype_code, stream_handle

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_plain",
           "flash_attention_vjp"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 112, 128, 256)
#: the C entry point's code for a TMA tensor map it could not encode
#: (plus the driver's CUresult)
ENCODE_ERROR = 20000
#: queries per block of the backward's recompute: the f32 scores of one
#: block at qwen3's training shape (B 4, H 16, Sk 2048) are 268 MB
BWD_Q_BLOCK = 512
#: the probability modes (the model's ``attn_probs_dtype``)
PROBS = ("float32", "compute")


def _valid(Sq: int, Sk: int, causal: bool, window: Optional[int],
           device: torch.device) -> torch.Tensor:
    """``[Sq, Sk]`` bool: key j is visible from query i."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    return valid


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, scale: float) -> torch.Tensor:
    """qg ``[B, Sq, KV, G, hd]``, k/v ``[B, Sk, KV, hd]`` (all f32), valid
    ``[Sq, Sk]`` -> ``[B, Sq, KV, G, hd]`` f32.  Masked scores take the
    lowest finite f32 and their probabilities are multiplied by 0, so a
    fully masked row gives 0 and the function has a gradient everywhere
    (a ``-inf`` fill would give NaN rows to repair in place)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * scale
    s = s.masked_fill(~valid, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1) * valid
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float.  A tensor times it
    rounds the exact product of the two once, as a product of two tensors
    of ``dtype`` does (no device tensor: a CUDA graph can capture it)."""
    return torch.tensor(x, dtype=dtype).item()


def _attend_compute(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`_attend` in the inputs' (compute) dtype, as the reference's
    ``_sdpa(..., probs_dtype="compute")`` orders it: scores and their
    scale rounded to the dtype, the row max held out of the gradient,
    ``p = exp(s - m)`` in the dtype, the unnormalised PV product, the
    row sums of ``p`` in f32 and the normalisation after PV.  Masked
    scores take the dtype's lowest value and their ``p`` is multiplied by
    0, so a fully masked row sums to 0 and gives 0."""
    dt = qg.dtype
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * _rounded(scale, dt)
    s = s.masked_fill(~valid, torch.finfo(dt).min)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m) * valid
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    denom = p.float().sum(dim=-1, keepdim=True)
    inv = (1.0 / denom.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    return o * inv.to(dt)


def _check_probs(probs: str) -> None:
    if probs not in PROBS:
        raise ValueError(f"flash_attention: probs={probs!r} not in {PROBS}")


def _attend_mode(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, scale: float,
                 probs: str) -> torch.Tensor:
    """One block of queries in ``probs`` mode, in q's dtype."""
    if probs == "compute":
        return _attend_compute(qg, k.to(qg.dtype), v.to(qg.dtype), valid,
                               scale)
    return _attend(qg.float(), k.float(), v.float(), valid,
                   scale).to(qg.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          probs: str = "float32") -> torch.Tensor:
    """q ``[B, Sq, H, hd]``; k/v ``[B, Sk, KV, hd]`` -> ``[B, Sq, H, hd]`` in
    q's dtype; fully masked rows give 0.  ``probs="float32"``:
    materialised f32 scores, softmax and PV product (the reference oracle
    ``ref.py:attention_ref``).  ``probs="compute"``: the same function in
    q's dtype with f32 row sums (:func:`_attend_compute`)."""
    _check_probs(probs)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    o = _attend_mode(q.reshape(B, Sq, KV, G, hd), k, v,
                     _valid(Sq, Sk, causal, window, q.device), scale, probs)
    return o.reshape(B, Sq, H, hd)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        q_block: int = BWD_Q_BLOCK,
                        probs: str = "float32"
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_plain` (in
    ``probs`` mode) at (q, k, v) against the cotangent ``dout``, in the
    inputs' dtypes.  The forward is recomputed ``q_block`` queries at a
    time, so the scores held at once are ``[B, KV, G, q_block, Sk]``,
    never the whole ``Sq x Sk``: each block's graph is built,
    differentiated and freed before the next.  Queries of different
    blocks share no term, so dq is exact per block and dk, dv are the
    blocks' f32 sums."""
    _check_probs(probs)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    valid = _valid(Sq, Sk, causal, window, q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    # the float32 mode differentiates in f32, the compute mode in q's dtype
    work = q.dtype if probs == "compute" else torch.float32
    with torch.enable_grad():
        kf = k.detach().to(work).requires_grad_(True)
        vf = v.detach().to(work).requires_grad_(True)
        for q0 in range(0, Sq, q_block):
            qb = q[:, q0:q0 + q_block].detach().requires_grad_(True)
            n = qb.shape[1]
            o = _attend_mode(qb.reshape(B, n, KV, G, hd), kf, vf,
                             valid[q0:q0 + n], scale, probs)
            o = o.reshape(B, n, H, hd)
            gq, gk, gv = torch.autograd.grad(o, (qb, kf, vf),
                                             dout[:, q0:q0 + n])
            dq[:, q0:q0 + n] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], scale: Optional[float],
            probs: str = "float32") -> torch.Tensor:
    """Check the CUDA tensors and launch the kernel once (counted: the
    bf16 compute-mode instances in ``flash_attention.compute_launches``,
    every other launch in ``flash_attention.launches``)."""
    _check_probs(probs)
    dev = check_cuda("flash_attention", q=q, k=k, v=v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KV, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd={hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window}")
    code = dtype_code(q, "flash_attention")
    # TMA (bf16) wants 16-byte aligned bases and strides; the f32 kernel
    # copies 4-byte words
    align = 16 if q.dtype == torch.bfloat16 else 4
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % align or any(
                st * t.element_size() % align for st in t.stride()[:-1]):
            raise ValueError(f"flash_attention: {name} is not {align}-byte "
                             f"aligned (base {t.data_ptr():#x}, strides "
                             f"{t.stride()})")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B * Sq * H == 0:
        return out
    compute = probs == "compute" and q.dtype == torch.bfloat16
    if compute:     # the kernel multiplies by the scale in bf16
        scale = _rounded(scale, torch.bfloat16)
    status = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, hd, ctypes.c_float(scale), int(causal), window or 0,
        int(compute), code, stream_handle(dev))
    if status >= ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: TMA tensor map encode failed "
                           f"(CUresult {status - ENCODE_ERROR})")
    check_status(status, "flash_attention")
    if compute:
        flash_attention.compute_launches += 1
    else:
        flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """The kernel in the forward; the backward is :func:`flash_attention_vjp`
    (the plain version's VJP in the same ``probs`` mode, recomputed in
    query blocks).  The TPU kernel has no backward kernel, so neither has
    this one yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, probs="float32"):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, probs)
        return _launch(q, k, v, causal, window, scale, probs)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, scale, probs = ctx.args
        dq, dk, dv = flash_attention_vjp(q, k, v, dout.contiguous(),
                                         causal=causal, window=window,
                                         scale=scale, probs=probs)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    probs: str = "float32") -> torch.Tensor:
    """Same contract as :func:`flash_attention_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``, the bf16 compute-mode
    instances in ``flash_attention.compute_launches``) or raise.  When
    grad is enabled and an input requires it, the launch runs inside
    :class:`FlashAttentionFn`, whose backward is the plain version's VJP;
    otherwise it runs bare, as serving and its captured graphs do."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, probs=probs)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, probs)
    return _launch(q, k, v, causal, window, scale, probs)


flash_attention.launches = 0
flash_attention.compute_launches = 0
