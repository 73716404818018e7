"""Chunked SSD (Mamba2) forward scan: CUDA kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan/kernel.py:ssm_scan_bh``
(wrapper ``ops.py:ssm_scan``).  The kernel is
``repro_torch/csrc/ssm_scan.cu``: one block per (batch, SSD head) walks the
chunks in order with the f32 state ``h [P, N]`` in shared memory for the
whole sequence.  One launch covers every head: the TPU wrapper's
``head_block`` split is a VMEM choice of that chip.  A ragged ``S`` is
handled exactly in the kernel, as the TPU wrapper's padding is (a zero dt
leaves the state unchanged, a zero C gives a zero output).

The plain version is the chunked SSD form, :func:`ssd_chunked` (which the
model's ``_ssd_chunked`` is), on the sequence padded to whole chunks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .._build import library
from .._common import check_cuda, check_status, dtype_code, stream_handle

__all__ = ["ssd_chunked", "ssm_scan", "ssm_scan_plain"]

#: limits of the kernel's shared-memory tiles
CHUNKS = (32, 64, 128)
MAX_P = 64
MAX_N = 64


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


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Same contract as :func:`ssm_scan_plain`, with y in x's dtype or f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``ssm_scan.launches``) or raise."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              out_dtype=out_dtype)
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
    y = torch.empty((B, S, H, P), dtype=out_dtype, device=dev)
    if B * S * H == 0:
        return y
    status = library().ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk, xc, yc,
        stream_handle(dev))
    check_status(status, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
