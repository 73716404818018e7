"""RMSNorm with an optional fused residual: CUDA kernel wrapper, its plain
PyTorch version, the launch plan and a CPU mirror of the kernel's order of
summation.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_rows``
(wrapper ``ops.py:rmsnorm``).  The kernel is ``repro_torch/csrc/rmsnorm.cu``:
memory-bound (each byte of x, residual and y crosses device memory once),
f32 statistics.  :func:`plan_rows` picks its path on the host: persistent
warps that bring their rows into a ring in shared memory by TMA bulk copies
and hold each row in registers, ``lpr`` lanes of ``vpl`` 16-byte vectors
each (a 128-wide bf16 row takes 16 lanes, so a warp holds two), the scale
held in registers per warp; a two-pass loop for widths without an instance
of that path; a scalar path for rows that allow no 16-byte access.  The port's decoder calls it without a residual, as the
reference model does; the residual form is the TPU kernel's and is checked
on the card all the same.  The kernel is forward-only, as the TPU kernel
is: under autograd it runs inside :class:`RMSNormFn`, whose backward is
the plain version's VJP.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .._build import library
from .._common import (check_cuda, check_status, dtype_code, sm_count,
                       stream_handle)

__all__ = ["RMSNormFn", "RowPlan", "plan_rows", "rmsnorm",
           "rmsnorm_lanes_plain", "rmsnorm_plain", "rmsnorm_vjp"]

#: warps per block on every path (``rmsnorm.cu``: ``BLOCK`` / 32)
WARPS_PER_BLOCK = 4
#: (lanes per row, 16-byte vectors per lane) the rows path is built for: the widths 64-7168 (bf16: 128 takes (16, 1), 1152 (16, 9), 2048
#: (32, 8), 3584 (32, 14); f32: 128 takes (32, 1), 1152 (32, 9), 2048
#: (32, 16), 3584 (32, 28)).  5120 and 6144 ((32, 20) and (32, 24) at
#: bf16) hold more than ``REG_WORDS`` and take the loop path.
ROW_INSTANCES = frozenset({(16, 1), (32, 1), (32, 2), (32, 4), (32, 8),
                           (16, 9), (32, 9), (32, 14), (32, 16), (32, 28)})
#: registers a lane may spend on its rows' x (and residual) and its columns
#: of the scale (``REG_WORDS``); those planned beside them for addresses,
#: counters and values in flight to the store
REG_WORDS = 128
REG_OTHER = 72
#: blocks per SM of the loop and scalar paths (their ``__launch_bounds__``)
LIGHT_BLOCKS_PER_SM = 8
#: the rows path's ring: stages per warp, the shared memory an SM plans on
#: and what each block leaves for the runtime and its barriers
STAGES = 3
SMEM_PER_SM = 227 * 1024
SMEM_RESERVED = 2048
#: path names, and their codes in ``rmsnorm_launch``
PATHS = {"scalar": 0, "loop": 1, "rows": 2}


class RowPlan(NamedTuple):
    """How one call is launched: ``path`` (``"rows"``, ``"loop"`` or
    ``"scalar"``), lanes per row ``lpr`` and 16-byte vectors per lane
    ``vpl`` (``lpr * vpl`` vectors tile the row; the scalar path has 32
    lanes per row and no vectors), rows a warp takes per step, warps per
    block, and the grid (blocks)."""

    path: str
    lpr: int
    vpl: int
    rows_per_warp: int
    warps_per_block: int
    grid: int


@functools.lru_cache(maxsize=512)
def plan_rows(rows: int, d: int, dtype: torch.dtype, sms: int,
              aligned: bool, *, scale_dtype: Optional[torch.dtype] = None,
              residual: bool = False) -> RowPlan:
    """The launch of ``rows`` rows of ``d`` elements of ``dtype`` on a card
    of ``sms`` SMs; ``aligned``: every pointer takes 16-byte access (the
    scale's vector of a bf16-scale, f32-x row: 8-byte).

    The vector paths need ``d`` to be a whole number of 16-byte vectors.
    The rows path further needs an instance of its (lanes, vectors) and a
    lane's x, residual and scale to fit in ``REG_WORDS`` registers; a lane
    holding fewer than 4 vectors of a row takes ``4 / vpl`` rows a step.
    The grid fills every SM once with the blocks per SM that the rows
    path's registers (its ``__launch_bounds__``) and ring of ``STAGES``
    steps per warp in shared memory allow, or fewer where the rows run out
    first; each warp strides over the rest."""
    x_item = torch.empty((), dtype=dtype).element_size()
    s_item = torch.empty((), dtype=scale_dtype or dtype).element_size()
    n = 16 // x_item
    if not aligned or d % n:
        path, lpr, vpl, rpw, per_sm = "scalar", 32, 0, 1, LIGHT_BLOCKS_PER_SM
    else:
        # lanes per row: the largest power of two <= 32 that divides the
        # row's count of 16-byte vectors
        lpr = 1
        while lpr < 32 and (d // n) % (2 * lpr) == 0:
            lpr *= 2
        vpl = d // n // lpr
        rpi = 1 if vpl >= 4 else 4 // vpl
        words = rpi * vpl * 4 * (2 if residual else 1) + vpl * n * s_item // 4
        if (lpr, vpl) in ROW_INSTANCES and words <= REG_WORDS:
            path, rpw = "rows", 32 // lpr * rpi
            smem = (WARPS_PER_BLOCK * STAGES * rpw * d * x_item
                    * (2 if residual else 1))
            per_sm = min(8, max(1, min(
                65536 // (32 * WARPS_PER_BLOCK * (words + REG_OTHER)),
                SMEM_PER_SM // (smem + SMEM_RESERVED))))
        else:
            path, rpw, per_sm = "loop", 32 // lpr, LIGHT_BLOCKS_PER_SM
    steps = -(-rows // rpw)
    grid = max(1, min(sms * per_sm, -(-steps // WARPS_PER_BLOCK)))
    return RowPlan(path, lpr, vpl, rpw, WARPS_PER_BLOCK, grid)


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


def rmsnorm_lanes_plain(x: torch.Tensor, scale: torch.Tensor,
                        residual: Optional[torch.Tensor], plan: RowPlan, *,
                        eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in its order (tests only;
    nothing on the main path calls it): each lane sums the squares of its
    values in f32, vector by vector (vector ``k`` of lane ``t`` holds
    columns ``(k * lpr + t) * n ..``; on the scalar path lane ``t`` holds
    columns ``t, t + 32, ..``), then an xor tree over the ``lpr`` lanes of
    the row adds the partials (offsets ``lpr / 2 .. 1``).  Same contract as
    :func:`rmsnorm_plain`."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    if residual is not None:
        xf = xf + residual.reshape(-1, d).float()
    rows = xf.shape[0]
    if plan.path == "scalar":
        per = -(-d // 32)
        cols = torch.zeros(rows, per * 32)
        cols[:, :d] = xf
        lanes = cols.reshape(rows, per, 1, 32)      # [row, k, element, lane]
    else:
        n = d // (plan.lpr * plan.vpl)
        lanes = xf.reshape(rows, plan.vpl, plan.lpr, n).transpose(2, 3)
    ss = torch.zeros(rows, lanes.shape[-1])
    for k in range(lanes.shape[1]):
        for e in range(lanes.shape[2]):
            v = lanes[:, k, e]
            ss = ss + v * v
    lane = torch.arange(ss.shape[1])
    o = ss.shape[1] // 2
    while o:
        ss = ss + ss[:, lane ^ o]
        o //= 2
    inv = torch.rsqrt(ss[:, :1] / d + eps)
    y = xf * inv * scale.float()
    return y.to(x.dtype).reshape(x.shape)


def _launch(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """Check the CUDA tensors and launch the kernel once (counted)."""
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
    ptrs = [x.data_ptr(), out.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    s_align = min(16, 16 // x.element_size() * scale.element_size())
    aligned = (all(p % 16 == 0 for p in ptrs)
               and scale.data_ptr() % s_align == 0)
    plan = plan_rows(rows, d, x.dtype, sm_count(dev.index), aligned,
                     scale_dtype=scale.dtype, residual=residual is not None)
    status = library().rmsnorm_launch(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), out.data_ptr(), rows, d, ctypes.c_float(eps), xc,
        sc, PATHS[plan.path], plan.lpr, plan.vpl, plan.grid,
        stream_handle(dev))
    check_status(status, "rmsnorm")
    rmsnorm.launches += 1
    return out


def rmsnorm_vjp(x: torch.Tensor, scale: torch.Tensor,
                residual: Optional[torch.Tensor], dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple:
    """The gradients ``(dx, dscale, dresidual)`` of :func:`rmsnorm_plain`
    at its inputs against the cotangent ``dy`` (``dresidual`` is ``None``
    without a residual), by recomputing it under autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, scale)]
        r = None
        if residual is not None:
            r = residual.detach().requires_grad_(True)
            ins.append(r)
        y = rmsnorm_plain(ins[0], ins[1], r, eps=eps)
        grads = torch.autograd.grad(y, ins, dy)
    return grads[0], grads[1], grads[2] if residual is not None else None


class RMSNormFn(torch.autograd.Function):
    """The kernel in the forward; the backward is :func:`rmsnorm_vjp` (the
    plain version's VJP).  The TPU kernel has no backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps):
        ctx.save_for_backward(x, scale, residual)
        ctx.eps = eps
        return _launch(x, scale, residual, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, residual = ctx.saved_tensors
        dx, dscale, dres = rmsnorm_vjp(x, scale, residual, dy, eps=ctx.eps)
        return dx, dscale, dres, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x ``[..., d]``, scale ``[d]``, residual like x -> y like x.

    CPU tensors take :func:`rmsnorm_plain`; CUDA tensors launch the kernel
    (counted in ``rmsnorm.launches``) or raise.  When grad is enabled and
    an input requires it, the launch runs inside :class:`RMSNormFn`, whose
    backward is the plain version's VJP (the residual gets its gradient
    too); otherwise it runs bare, as serving and its captured graphs do."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, residual, eps=eps)
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad
            or (residual is not None and residual.requires_grad)):
        return RMSNormFn.apply(x, scale, residual, eps)
    return _launch(x, scale, residual, eps)


rmsnorm.launches = 0
