"""Mixture-of-Experts block (port of ``repro.models.moe``).

The reference has two dispatch paths.  Its **one-hot path** (decode, small
token counts, no mesh) is the Switch-style dispatch einsum: each (token,
slot) pair takes the next free row of its expert's buffer, up to a
capacity of ``ceil(T * k / E * capacity_factor)`` rows for the call's T
tokens; pairs past it are dropped (they ride the residual).  Its **a2a
path** shards tokens and experts over a device mesh and exchanges buckets
with an all-to-all; it needs a mesh, which the port does not have yet, so
``moe_block`` always computes the one-hot path's function.

The one-hot einsum costs O(T * E * cap * d): at a 4096-token prefill of 64
experts that is petaflops of multiplications by zero.  The port computes
the same function by index.  The running count of each expert over the
flattened (token, slot) pairs in token-major order gives each pair its
row, so the same pairs are dropped; kept pairs are copied into an
``[E, cap, d]`` buffer (dropped ones into a spare row that is cut off),
the experts run as batched products, and each pair reads its row back,
weighted by its gate value in the compute dtype and summed over the k
slots.  Every shape is static (no ``nonzero``, no boolean-mask indexing,
no host sync), so a decode step with MoE blocks can be captured in a CUDA
graph.  No TPU kernel computes any of this; it is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = ["moe_specs", "moe_block"]


def moe_specs(cfg: ModelConfig) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)
    specs = {
        "router": ParamSpec((d, E), ("embed", None), "normal", s_in),
        "wi": ParamSpec((E, d, f), ("expert", "expert_mlp", None), "normal", s_in),
        "wg": ParamSpec((E, d, f), ("expert", "expert_mlp", None), "normal", s_in),
        "wo": ParamSpec((E, f, d), ("expert", "expert_mlp", None), "normal", s_out),
    }
    if cfg.mlp_act != "swiglu":
        del specs["wg"]
    return specs


def _gates(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor):
    """Router in f32: (weights ``[T, k]`` f32, expert indices ``[T, k]``,
    Switch load-balance loss ``E * sum_e f_e * P_e``)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                  # [E] mean prob
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)   # [E] top-1 share
    return gate_vals, gate_idx, E * (me * ce).sum()


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows per expert for a call of ``tokens`` tokens (the reference's
    ``cap``)."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def _slots(gate_idx: torch.Tensor, n_experts: int,
           cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each flattened (token, slot) pair's buffer row ``e * cap + pos``
    and whether it is kept (``pos < cap``), ``pos`` being the pairs of the
    same expert before it in token-major order."""
    flat_e = gate_idx.reshape(-1)
    # the running count per expert along each expert's own row (a scan
    # along the last dimension: down the columns of the [T*k, E] one-hot
    # it runs one thread per expert)
    counts = F.one_hot(flat_e, n_experts).t().contiguous().cumsum(dim=1)
    pos = counts.gather(0, flat_e[None, :])[0] - 1
    return flat_e * cap + pos, pos < cap


def _expert_mlp(cfg: ModelConfig, xs: torch.Tensor, wi: torch.Tensor,
                wg: Optional[torch.Tensor], wo: torch.Tensor) -> torch.Tensor:
    """xs ``[E, C, d]`` -> ``[E, C, d]`` through each expert."""
    h = torch.bmm(xs, wi)
    if wg is not None:
        h = F.silu(torch.bmm(xs, wg)) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo)


def _moe_indexed(cfg: ModelConfig, xt: torch.Tensor, gate_vals: torch.Tensor,
                 gate_idx: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """The one-hot path's function by index.  xt ``[T, d]``, gate_vals
    ``[T, k]`` in the compute dtype -> ``[T, d]``."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T)
    row, keep = _slots(gate_idx, E, cap)
    spare = E * cap                               # where dropped pairs go
    dest = torch.where(keep, row, spare)
    src = torch.arange(T * k, device=xt.device) // k          # pair's token
    buf = xt.new_zeros((spare + 1, d))
    buf.index_copy_(0, dest, xt[src])
    ye = _expert_mlp(cfg, buf[:spare].view(E, cap, d), wi, wg, wo)
    sel = ye.reshape(spare, d)[torch.where(keep, row, 0)]
    sel = sel * keep[:, None].to(xt.dtype)
    out = sel * gate_vals.reshape(-1)[:, None]
    return out.reshape(T, k, d).sum(dim=1)


def moe_block(p: dict, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, load-balance loss, f32 scalar).

    The reference's one-hot path, for any token count (the expert-parallel
    all-to-all path needs a device mesh the port does not have yet)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gate_vals, gate_idx, lb = _gates(cfg, xt, p["router"])
    y = _moe_indexed(cfg, xt, gate_vals.to(x.dtype), gate_idx, p["wi"],
                     p.get("wg"), p["wo"])
    return y.reshape(B, S, d), lb
