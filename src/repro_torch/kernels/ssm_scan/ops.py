"""Chunked SSD (Mamba2) forward scan: CUDA kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan/kernel.py:ssm_scan_bh``
(wrapper ``ops.py:ssm_scan``).  The kernel is
``repro_torch/csrc/ssm_scan.cu``, chunk-parallel: the chunks are cut into
groups of :func:`plan_groups` consecutive chunks; a state launch writes
each group's end state from zero, a pass launch turns those into the
state entering each group, and an output launch computes y for every
(batch, group, head) from it (one launch when there is one group).  bf16
products run on tensor cores with the f32 operands split into bf16
hi + lo pairs; f32 runs the same launches with f32 FMAs.  The TPU
wrapper's ``head_block`` split is a VMEM choice of that chip.  A ragged
``S`` is handled exactly in the kernel, as the TPU wrapper's padding is (a
zero dt leaves the state unchanged, a zero C gives a zero output).

The plain version is the chunked SSD form, :func:`ssd_chunked` (which the
model's ``_ssd_chunked`` is), on the sequence padded to whole chunks.
:func:`ssm_scan_phases_plain` is the kernel's three-phase arithmetic,
rounding points included, for the CPU tests; nothing else calls it.

The kernel is forward-only, as the TPU kernel is: under autograd it runs
inside :class:`SSMScanFn`, whose backward is the plain version's VJP.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .._build import library
from .._common import (check_cuda, check_status, dtype_code, sm_count,
                       stream_handle)

__all__ = ["SSMScanFn", "plan_groups", "round_hi_lo", "ssd_chunked",
           "ssm_scan", "ssm_scan_phases_plain", "ssm_scan_plain",
           "ssm_scan_vjp"]

#: limits of the kernel's shared-memory tiles
CHUNKS = (32, 64, 128)
MAX_P = 64
MAX_N = 64
#: output blocks per SM, at least, that the chunk groups must leave: with
#: fewer, a partial last wave of blocks costs a large share of the time
MIN_WAVES = 6


def plan_groups(S: int, chunk: int, bh: int, sms: int) -> int:
    """Chunks per group for ``S`` steps, ``bh`` (batch x head) rows and a
    card of ``sms`` SMs: the largest power of two that leaves at least
    ``MIN_WAVES`` (batch, group, head) output blocks per SM, so the state
    scratch (one [P, N] state per group) stays small while the card stays
    full.  1 when even one chunk per group gives fewer blocks; never more
    than the chunks there are."""
    n_chunks = -(-S // chunk)
    g = 1
    while 2 * g <= n_chunks and bh * -(-n_chunks // (2 * g)) >= MIN_WAVES * sms:
        g *= 2
    return g


def round_hi_lo(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 kernel carries an f32 operand: a bf16 ``hi`` and
    the bf16-rounded remainder ``lo``, summed back in f32."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bs: torch.Tensor, Cs: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Structured state-space duality, chunked (port of
    ``repro.models.ssm._ssd_chunked``).

    xh ``[B, S, H, P]``; dt ``[B, S, H]`` f32; A ``[H]`` (negative); Bs/Cs
    ``[B, S, N]``.  Returns ``(y [B, S, H, P] f32, h_final [B, H, P, N] f32)``.
    All of the math is f32."""
    B, S, H, P = xh.shape
    N = Bs.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    dA = dt * A[None, None, :]                          # [B, S, H] (<= 0)
    xc = xh.float().reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    dAc = dA.reshape(B, nc, chunk, H)
    Bc = Bs.float().reshape(B, nc, chunk, N)
    Cc = Cs.float().reshape(B, nc, chunk, N)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    ys = []
    for c in range(nc):
        xq, dtq, dAq, Bq, Cq = xc[:, c], dtc[:, c], dAc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dAq, dim=1)                  # [B, Q, H]
        total = cum[:, -1:, :]                          # [B, 1, H]
        li = cum[:, :, None, :] - cum[:, None, :, :]    # [B, Q, Q, H]
        # above the diagonal li > 0 may overflow exp to inf; masking the
        # exponent first keeps the VJP finite (where's zero cotangent
        # times inf is NaN).  The reference masks only after exp, so its
        # gradient is NaN once a chunk's decay passes ~88 nats.
        li = torch.where(mask[None, :, :, None], li, 0.0)
        L = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bqn,bkn->bqk", Cq, Bq)
        xdt = xq * dtq[..., None]                       # [B, Q, H, P]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores[..., None] * L, xdt)
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, h) * \
            torch.exp(cum)[..., None]
        decay_in = torch.exp(total - cum)               # [B, Q, H]
        upd = torch.einsum("bkn,bkhp->bhpn", Bq, xdt * decay_in[..., None])
        h = h * torch.exp(total[:, 0, :])[:, :, None, None] + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y, h


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x ``[B, S, H, P]``; dt ``[B, S, H]`` f32; A ``[H]`` f32 (negative);
    Bm/Cm ``[B, S, N]`` -> y ``[B, S, H, P]`` in ``out_dtype`` (default x's
    dtype).  The state starts at 0 and is not returned, as in the TPU
    kernel.  A ragged S is zero-padded to whole chunks, which is exact."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, _ = ssd_chunked(x, dt.float(), A.float(), Bm, Cm, chunk)
    return y[:, :S].to(out_dtype or x.dtype)


def ssm_scan_phases_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor, *,
                          chunk: int = 128, groups: int,
                          round_bf16: Optional[bool] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (tests only): the chunks in
    groups of ``groups``; phase 1, each group's end state from zero and its
    total of dt * A (all groups but the last); phase 2, the state entering
    each group, in order; phase 3, per chunk ``y = W x + exp(cum) o (C
    h^T)`` with ``W = (C B^T) o exp(cum_q - cum_k) o dt_k`` (k <= q), the
    state carried through the group.  With ``round_bf16`` (default: x is
    bf16) W, the state read by ``C h^T`` and ``x dt exp(total - cum)`` pass
    through :func:`round_hi_lo`, where the bf16 kernel splits them.
    Same inputs as :func:`ssm_scan_plain`; y in f32."""
    if round_bf16 is None:
        round_bf16 = x.dtype == torch.bfloat16
    rnd = round_hi_lo if round_bf16 else (lambda t: t)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, Q, H, P)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    cum = torch.cumsum(dtc * A.float(), dim=2)            # [B, nc, Q, H]
    total = cum[:, :, -1]                                 # [B, nc, H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    n_groups = -(-nc // groups)
    spans = [range(g * groups, min((g + 1) * groups, nc))
             for g in range(n_groups)]

    def update(h, c):
        dec = dtc[:, c] * torch.exp(total[:, c, None] - cum[:, c])
        xd = rnd(xf[:, c] * dec[..., None])               # [B, Q, H, P]
        return h * torch.exp(total[:, c])[:, :, None, None] + \
            torch.einsum("bqhp,bqn->bhpn", xd, Bc[:, c])

    zero = torch.zeros((B, H, P, N))
    ends, tots = [], []                                   # phase 1
    for span in spans[:-1]:
        h, tot = zero, torch.zeros((B, H))
        for c in span:
            h, tot = update(h, c), tot + total[:, c]
        ends.append(h)
        tots.append(tot)
    h_in, h = [zero], zero                                # phase 2
    for s_end, tot in zip(ends, tots):
        h = torch.exp(tot)[:, :, None, None] * h + s_end
        h_in.append(h)
    ys = []                                               # phase 3
    for span, h in zip(spans, h_in):
        for c in span:
            cq = cum[:, c]
            li = torch.where(mask[None, :, :, None],
                             cq[:, :, None, :] - cq[:, None, :, :], 0.0)
            L = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
            scores = torch.einsum("bqn,bkn->bqk", Cc[:, c], Bc[:, c])
            W = rnd(scores[..., None] * L * dtc[:, c][:, None, :, :])
            y = torch.einsum("bqkh,bkhp->bqhp", W, xf[:, c])
            y = y + torch.einsum("bqn,bhpn->bqhp", Cc[:, c], rnd(h)) * \
                torch.exp(cq)[..., None]
            ys.append(y)
            if c + 1 < span.stop:
                h = update(h, c)
    return torch.stack(ys, dim=1).reshape(B, nc * Q, H, P)[:, :S]


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Check the CUDA tensors and run one call's launches (counted once)."""
    dev = check_cuda("ssm_scan", x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) \
            or Bm.shape != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if chunk not in CHUNKS:
        raise ValueError(f"ssm_scan: chunk={chunk} not in {CHUNKS}")
    if P % 16 or not 16 <= P <= MAX_P or N % 16 or not 16 <= N <= MAX_N:
        raise ValueError(f"ssm_scan: P={P}, N={N} (each a multiple of 16, "
                         f"P <= {MAX_P}, N <= {MAX_N})")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssm_scan: dt and A must be float32")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssm_scan: B and C must share x's dtype")
    out_dtype = out_dtype or x.dtype
    xc = dtype_code(x, "ssm_scan x")
    yc = dtype_code(out_dtype, "ssm_scan out")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"ssm_scan out: {out_dtype} for x {x.dtype} (y is "
                        f"x's dtype or float32)")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssm_scan: {name} is not 16-byte aligned")
    y = torch.empty((B, S, H, P), dtype=out_dtype, device=dev)
    if B * S * H == 0:
        return y
    groups = plan_groups(S, chunk, B * H, sm_count(dev.index or 0))
    slots = -(-(-(-S // chunk)) // groups) - 1
    scratch = None
    if slots:           # each group's state [P, N] and its total, f32
        scratch = torch.empty(B * slots * H * (P * N + 1),
                              dtype=torch.float32, device=dev)
    status = library().ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, S, H, P, N,
        chunk, groups, xc, yc, stream_handle(dev))
    check_status(status, "ssm_scan")
    ssm_scan.launches += 1
    return y


def ssm_scan_vjp(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128,
                 out_dtype: Optional[torch.dtype] = None) -> tuple:
    """The gradients ``(dx, ddt, dA, dB, dC)`` of :func:`ssm_scan_plain` at
    its inputs against the cotangent ``dy``, by recomputing it under
    autograd (its chunked form keeps one chunk's ``[B, Q, Q, H]`` decay
    matrix at a time in the forward; autograd keeps every chunk's)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y = ssm_scan_plain(*ins, chunk=chunk, out_dtype=out_dtype)
        return torch.autograd.grad(y, ins, dy)


class SSMScanFn(torch.autograd.Function):
    """The kernel in the forward; the backward is :func:`ssm_scan_vjp` (the
    plain version's VJP).  The TPU kernel has no backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, out_dtype):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.args = (chunk, out_dtype)
        return _launch(x, dt, A, Bm, Cm, chunk, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        chunk, out_dtype = ctx.args
        grads = ssm_scan_vjp(*ctx.saved_tensors, dy, chunk=chunk,
                             out_dtype=out_dtype)
        return (*grads, None, None)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Same contract as :func:`ssm_scan_plain`, with y in x's dtype or f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  One call counts once in ``ssm_scan.launches``, though it runs
    up to three launches (state, pass and output; the first two only when
    :func:`plan_groups` gives more than one group), with the f32 state
    scratch allocated here by ``torch.empty``.  When grad is enabled and
    an input requires it, the call runs inside :class:`SSMScanFn`, whose
    backward is the plain version's VJP; otherwise it runs bare."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              out_dtype=out_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SSMScanFn.apply(x, dt, A, Bm, Cm, chunk, out_dtype)
    return _launch(x, dt, A, Bm, Cm, chunk, out_dtype)


ssm_scan.launches = 0
