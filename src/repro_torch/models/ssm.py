"""Mamba2 (SSD) blocks (port of the Mamba2 half of ``repro.models.ssm``).

The full-sequence block runs the chunked SSD scan through the ``ssm_scan``
kernel wrapper, asking it for an f32 ``y``: the reference's
``_ssd_chunked`` returns f32, and the ``D`` skip and the gated RMSNorm
that follow are f32 too, so the kernel path rounds nowhere the reference
does not.  ``plain=True`` runs the chunked form itself (``_ssd_chunked``).
Decode is the O(1) recurrent update on a cached state, written in place.

Left for a later slice: xLSTM (mLSTM, sLSTM).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import ssd_chunked as _ssd_chunked
from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = ["mamba2_specs", "mamba2_forward", "mamba2_decode",
           "mamba2_init_state", "MambaState"]


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    headdim = 64
    nheads = cfg.ssm_heads or d_inner // headdim
    headdim = d_inner // nheads
    return d_inner, nheads, headdim


def mamba2_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, nheads, headdim = _mamba_dims(cfg)
    N = cfg.ssm_state
    s = 1.0 / math.sqrt(d)
    return {
        # fused input projection -> [z | x | B | C | dt]
        "w_in": ParamSpec((d, 2 * d_inner + 2 * N + nheads),
                          ("embed", "mlp"), "normal", s),
        "conv_w": ParamSpec((cfg.ssm_conv, d_inner), ("conv", "mlp"), "normal", 0.2),
        "A_log": ParamSpec((nheads,), (None,), "zeros"),
        "D": ParamSpec((nheads,), (None,), "ones"),
        "dt_bias": ParamSpec((nheads,), (None,), "zeros"),
        "norm_scale": ParamSpec((d_inner,), ("mlp",), "ones"),
        "w_out": ParamSpec((d_inner, d), ("mlp", "embed"), "normal",
                           1.0 / math.sqrt(d_inner)),
    }


def _mamba_proj(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x ``[B, S, d]`` -> z, xs, Bs, Cs, dt (pre-conv; dt f32)."""
    d_inner, nheads, _ = _mamba_dims(cfg)
    N = cfg.ssm_state
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    z, xs, Bs, Cs, dt = torch.split(
        proj, [d_inner, d_inner, N, N, nheads], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, xs, Bs, Cs, dt


def _causal_conv(xs: torch.Tensor, conv_w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xs ``[B, S, D]``, conv_w ``[K, D]``.
    Returns ``(silu(conv), new_state [B, K-1, D])``."""
    K = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((xs.shape[0], K - 1, xs.shape[2]), dtype=xs.dtype,
                          device=xs.device)
    else:
        pad = state.to(xs.dtype)
    xp = torch.cat([pad, xs], dim=1)                    # [B, S+K-1, D]
    S = xs.shape[1]
    out = sum(xp[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return F.silu(out), new_state


def _gated_norm(p: dict, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm in f32 (inline in the reference, not ``apply_norm``)."""
    ms = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(ms + cfg.norm_eps) * p["norm_scale"].float()
    return (y * F.silu(z.float())).to(dtype)


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   chunk: int = 128, *, plain: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block (prefill).  x ``[B, S, d]``.

    ``plain=True`` runs the chunked SSD form with ``min(chunk, S)`` as the
    reference does (S a multiple of it); the kernel path takes any S."""
    B, S, _ = x.shape
    d_inner, nheads, headdim = _mamba_dims(cfg)
    z, xs, Bs, Cs, dt = _mamba_proj(p, cfg, x)
    xs, _ = _causal_conv(xs, p["conv_w"])
    xh = xs.reshape(B, S, nheads, headdim)
    A = -torch.exp(p["A_log"].float())
    if plain:
        y, _ = _ssd_chunked(xh, dt, A, Bs, Cs, min(chunk, S))
    else:
        # the kernel masks a ragged last chunk itself, so a short sequence
        # keeps the model's chunk (the same math as chunk = S)
        y = ssm_scan(xh.contiguous(), dt.contiguous(), A, Bs.contiguous(),
                     Cs.contiguous(), chunk=chunk, out_dtype=torch.float32)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = _gated_norm(p, cfg, y.reshape(B, S, d_inner), z, x.dtype)
    return torch.einsum("bse,ed->bsd", y, p["w_out"])


class MambaState(NamedTuple):
    h: torch.Tensor       # [B, H, P, N] f32
    conv: torch.Tensor    # [B, K-1, d_inner]


def mamba2_init_state(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> MambaState:
    """Zero SSD state and conv window on ``device`` (``None``: the card;
    pass ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    d_inner, nheads, headdim = _mamba_dims(cfg)
    return MambaState(
        h=torch.zeros((batch, nheads, headdim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_inner), dtype=dtype,
                         device=device))


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One-token recurrent update.  x ``[B, 1, d]``.

    Unlike the reference, which returns a new state, the port writes the
    new ``h`` and conv window into ``state``'s tensors IN PLACE and returns
    the same ``state``."""
    B = x.shape[0]
    d_inner, nheads, headdim = _mamba_dims(cfg)
    z, xs, Bs, Cs, dt = _mamba_proj(p, cfg, x)
    xs, conv_state = _causal_conv(xs, p["conv_w"], state=state.conv)
    xh = xs.reshape(B, nheads, headdim).float()
    A = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0, :]                                   # [B, H]
    dec = torch.exp(dt1 * A[None, :])                   # [B, H]
    upd = torch.einsum("bn,bh,bhp->bhpn", Bs[:, 0].float(), dt1, xh)
    h = state.h * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cs[:, 0].float(), h)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(p, cfg, y.reshape(B, 1, d_inner), z, x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return out, state
