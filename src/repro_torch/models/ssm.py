"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM)
(port of ``repro.models.ssm``).

The full-sequence block runs the chunked SSD scan through the ``ssm_scan``
kernel wrapper, asking it for an f32 ``y``: the reference's
``_ssd_chunked`` returns f32, and the ``D`` skip and the gated RMSNorm
that follow are f32 too, so the kernel path rounds nowhere the reference
does not.  ``plain=True`` runs the chunked form itself (``_ssd_chunked``).
Decode is the O(1) recurrent update on a cached state, written in place.

xLSTM: the full-sequence mLSTM and sLSTM are loops over time with f32
states.  The reference nests its ``lax.scan`` over time in checkpointed
chunks (``_chunked_time_scan``), which only changes what its backward
pass stores: the forward is the same flat recurrence.  No TPU kernel
computes either cell, so both stay plain PyTorch; the prefill's time loop
is bound by the host's launches.

**Tensor parallelism** (under an active sharding context whose rules
split a block's leaves over ``model``; every block is laid out as the
active rules' layout says, never from its local shapes):

- Mamba2, where the rules split ``d_inner`` (``conv_w``, ``norm_scale``,
  ``w_out``) and the SSM heads tile the model axis: each rank runs its
  block of the heads (:func:`mamba_heads`).  ``w_in`` keeps the
  reference's storage, ``[d, 2 d_inner + 2 N + H]`` cut contiguously
  over ``model``, so a rank's block does not line up with the ``[z | x |
  B | C | dt]`` segments: each rank multiplies by its block of columns,
  the products are gathered whole (``collectives.gather_dim``, whose
  backward reduce-scatters the gradient) and the rank takes its z and x
  blocks, B and C whole and its dt block -- the reference's columns, with
  the gather on the projection (``[B, S, 14576]`` at full width) instead
  of the weight (``[3584, 14576]``).  ``A_log``, ``D`` and ``dt_bias`` are whole and sliced to the
  rank's heads (as is ``w_in`` where the rules keep it whole): their
  gradients are a rank's part, which the train step sums over ``model``
  (:func:`mamba_partial_leaves`).  The gated RMSNorm averages over the
  whole ``d_inner``: its sum of squares is a ``collectives.shared_sum``
  (all-reduced forward and backward).  ``w_out`` is row-parallel and the
  block ends with ``reduce_from_model``.  Where the heads do not tile the
  model axis (reduced zamba2 on four ranks: 2 heads), the block runs
  replicated, every leaf the rules split gathered whole
  (``collectives.gather``: each rank keeps its block of the gradient).
- mLSTM under xlstm's rules (heads replicated, ``d_in`` over ``model``):
  ``w_up`` / ``w_gate`` column-parallel, ``wq`` / ``wk`` / ``wv`` /
  ``w_if`` row-parallel with their partial products summed over
  ``model`` in one ``reduce_from_model``, in f32 and rounded to the
  compute dtype once after the sum, as the whole contraction is (at bf16
  a sum of rounded partials moved the gates, which go through
  exponentials, visibly off the one-rank step); the cell runs replicated with
  every head, the output gate gathered whole, ``wo`` / ``o_norm`` /
  ``b_if`` whole, so their gradients are the whole ones on every rank.
- sLSTM: no leaf split (its heads are whole under xlstm's rules); the
  block runs replicated and issues no collective.  Rules that split the
  mLSTM's or the sLSTM's heads raise ``NotImplementedError``.

Decode under a mesh passes each block the rank's rows of its states;
where a block computes with the whole of a state the rules cut over
``model``, ``models.transformer`` gathers it first (:func:`state_whole`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import active_ctx
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import ssd_chunked as _ssd_chunked
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.layers import out_proj

__all__ = ["mamba2_specs", "mamba2_forward", "mamba2_decode",
           "mamba2_init_state", "MambaState",
           "mlstm_specs", "mlstm_forward", "mlstm_decode", "mlstm_init_state",
           "MLSTMState",
           "slstm_specs", "slstm_forward", "slstm_decode", "slstm_init_state",
           "SLSTMState", "mamba_heads", "mamba_partial_leaves",
           "state_whole", "check_heads"]


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


def _split_over_model(cfg: ModelConfig, kind: str) -> dict:
    """``{leaf: dim}`` of the leaves of one ``kind`` block ("mamba",
    "mlstm", "slstm") that the active rules split over ``model``, with the
    dim each splits; empty without a context or a model axis (once per
    context and config)."""
    ctx = active_ctx()
    if ctx is None or ctx.axis_size("model") == 1:
        return {}
    key = ("split_over_model", cfg, kind)
    if key not in ctx.memo:
        specs = {"mamba": mamba2_specs, "mlstm": mlstm_specs,
                 "slstm": slstm_specs}[kind](cfg)
        out = {}
        for name, s in specs.items():
            for dim, axes in enumerate(ctx.layout(s.logical, s.shape)):
                if "model" in axes:
                    if axes != ("model",):
                        raise NotImplementedError(
                            f"{cfg.name}: {kind}/{name} split over {axes} "
                            f"(ROADMAP Queue 1 item 2)")
                    out[name] = dim
        ctx.memo[key] = out
    return ctx.memo[key]


def check_heads(cfg: ModelConfig, kind: str) -> None:
    """Raise ``NotImplementedError``, before any collective, where the
    active rules split the heads of an ``"mlstm"`` or ``"slstm"`` block
    over ``model`` (the mLSTM takes its ``d_in`` split, ``_D_IN``; the
    sLSTM runs replicated)."""
    split = _split_over_model(cfg, kind)
    if split.items() - (_D_IN.items() if kind == "mlstm" else set()):
        raise NotImplementedError(
            f"{cfg.name}: rules that split the {kind} block's "
            f"{sorted(split)} over 'model' (its heads; xlstm's rules keep "
            f"them whole): ROADMAP Queue 1 item 2")


def mamba_heads(cfg: ModelConfig) -> Optional[slice]:
    """This rank's block of the Mamba2 heads under the active rules: where
    they split ``d_inner`` over ``model`` and the heads tile the model
    axis; ``None`` where every rank runs every head."""
    split = _split_over_model(cfg, "mamba")
    _, H, _ = _mamba_dims(cfg)
    if "conv_w" not in split:
        return None
    ctx = active_ctx()
    M = ctx.axis_size("model")
    if H % M:
        return None
    n = H // M
    h0 = ctx.mesh.coordinate()["model"] * n
    return slice(h0, h0 + n)


def mamba_partial_leaves(cfg: ModelConfig) -> tuple:
    """The Mamba2 leaves whole over ``model`` that a rank uses only on its
    heads (:func:`mamba_heads`), so that their gradient on a rank is a
    part, summed over ``model`` by the train step: the per-head leaves,
    and ``w_in`` where the rules keep it whole."""
    if mamba_heads(cfg) is None:
        return ()
    whole_w_in = "w_in" not in _split_over_model(cfg, "mamba")
    return ("A_log", "D", "dt_bias") + (("w_in",) if whole_w_in else ())


def state_whole(cfg: ModelConfig, kind: str) -> bool:
    """Whether a ``kind`` block's decode computes with its whole states
    (every head) on each rank: all but a Mamba2 block on its heads."""
    return not (kind == "mamba" and mamba_heads(cfg) is not None)


def _mamba_local(p: dict, cfg: ModelConfig):
    """(the leaves as this rank computes with them, the model group when
    it runs its block of the heads or ``None``, the ``[z | x | B | C |
    dt]`` columns of the gathered projection it takes or ``None``).  Under
    tensor parallelism on the heads: the per-head leaves sliced to this
    rank's, and either ``w_in``'s storage block kept (its projection is
    gathered whole and the rank takes its z and x blocks, B and C whole
    and its dt block) or, where the rules keep ``w_in`` whole, those
    columns of it; with split leaves but the heads whole, every split
    leaf gathered; else ``p``."""
    split = _split_over_model(cfg, "mamba")
    if not split:
        return p, None, None
    group = active_ctx().model_group()
    heads = mamba_heads(cfg)
    if heads is None:
        # replicated: each rank keeps its block of the whole gradient
        return {k: C.gather(t, group, split[k]) if k in split else t
                for k, t in p.items()}, None, None
    d_inner, _, P = _mamba_dims(cfg)
    h0, h1 = heads.start, heads.stop
    dt0 = 2 * d_inner + 2 * cfg.ssm_state
    cols = ((h0 * P, h1 * P), (d_inner + h0 * P, d_inner + h1 * P),
            (2 * d_inner, dt0), (dt0 + h0, dt0 + h1))
    q = dict(p)
    for k in ("A_log", "D", "dt_bias"):
        q[k] = p[k][h0:h1]
    if "w_in" in split:
        return q, group, cols
    q["w_in"] = torch.cat([p["w_in"][:, a:b] for a, b in cols], dim=1)
    return q, group, None


def _mamba_proj(p: dict, cfg: ModelConfig, x: torch.Tensor, group=None,
                cols=None):
    """x ``[B, S, d]`` -> z, xs, Bs, Cs, dt (pre-conv; dt f32), at the
    width of ``p`` (this rank's heads under tensor parallelism).  With
    ``cols`` ``p["w_in"]`` is this rank's storage block of columns: the
    products of every rank's block are gathered over ``group``
    (``collectives.gather_dim``: the backward reduce-scatters the
    gradient, each rank's segments and its part of B and C summed) and
    the ``cols`` ranges taken."""
    d_inner, nheads = p["conv_w"].shape[1], p["A_log"].shape[0]
    N = cfg.ssm_state
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    if cols is not None:
        proj = C.gather_dim(proj, group, 2)
        proj = torch.cat([proj[..., a:b] for a, b in cols], dim=-1)
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
                z: torch.Tensor, dtype: torch.dtype,
                group=None) -> torch.Tensor:
    """Gated RMSNorm in f32 (inline in the reference, not ``apply_norm``).
    With ``group`` ``y`` is this rank's block of ``d_inner``: the sum of
    squares is summed over the group (``collectives.shared_sum``)."""
    if group is None:
        ms = y.square().mean(dim=-1, keepdim=True)
    else:
        ms = C.shared_sum(y.square().sum(dim=-1, keepdim=True),
                          group) / _mamba_dims(cfg)[0]
    y = y * torch.rsqrt(ms + cfg.norm_eps) * p["norm_scale"].float()
    return (y * F.silu(z.float())).to(dtype)


def _mamba_out(p: dict, y: torch.Tensor, group) -> torch.Tensor:
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    return out if group is None else C.reduce_from_model(out, group)


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   chunk: int = 128, *, plain: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block (prefill).  x ``[B, S, d]``.

    ``plain=True`` runs the chunked SSD form with ``min(chunk, S)`` as the
    reference does (S a multiple of it); the kernel path takes any S."""
    B, S, _ = x.shape
    p, group, cols = _mamba_local(p, cfg)
    if group is not None:
        x = C.copy_to_model(x, group)
    z, xs, Bs, Cs, dt = _mamba_proj(p, cfg, x, group, cols)
    xs, _ = _causal_conv(xs, p["conv_w"])
    d_inner, nheads = xs.shape[-1], dt.shape[-1]
    xh = xs.reshape(B, S, nheads, d_inner // nheads)
    A = -torch.exp(p["A_log"].float())
    if plain:
        y, _ = _ssd_chunked(xh, dt, A, Bs, Cs, min(chunk, S))
    else:
        # the kernel masks a ragged last chunk itself, so a short sequence
        # keeps the model's chunk (the same math as chunk = S)
        y = ssm_scan(xh.contiguous(), dt.contiguous(), A, Bs.contiguous(),
                     Cs.contiguous(), chunk=chunk, out_dtype=torch.float32)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = _gated_norm(p, cfg, y.reshape(B, S, d_inner), z, x.dtype, group)
    return _mamba_out(p, y, group)


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
    the same ``state``.  Under tensor parallelism on the heads ``state`` is
    this rank's block of them (``models.transformer.init_cache``)."""
    B = x.shape[0]
    p, group, cols = _mamba_local(p, cfg)
    if group is not None:
        x = C.copy_to_model(x, group)
    z, xs, Bs, Cs, dt = _mamba_proj(p, cfg, x, group, cols)
    xs, conv_state = _causal_conv(xs, p["conv_w"], state=state.conv)
    d_inner, nheads = xs.shape[-1], dt.shape[-1]
    xh = xs.reshape(B, nheads, d_inner // nheads).float()
    A = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0, :]                                   # [B, H]
    dec = torch.exp(dt1 * A[None, :])                   # [B, H]
    upd = torch.einsum("bn,bh,bhp->bhpn", Bs[:, 0].float(), dt1, xh)
    h = state.h * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cs[:, 0].float(), h)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(p, cfg, y.reshape(B, 1, d_inner), z, x.dtype, group)
    out = _mamba_out(p, y, group)
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return out, state


# ================================================================== mLSTM

def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(heads, head_dim, d_in): the cell runs at d_in = proj_factor *
    d_model; with proj_factor 0 the cell runs at d_model."""
    H = cfg.n_heads
    d_in = int(cfg.mlstm_proj_factor * cfg.d_model) or cfg.d_model
    return H, d_in // H, d_in


def _slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """sLSTM always runs at d_model (no up-projection)."""
    H = cfg.n_heads
    return H, cfg.d_model // H


def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, hd, d_in = _mlstm_dims(cfg)
    s = 1.0 / math.sqrt(d)
    si = 1.0 / math.sqrt(d_in)
    specs = {
        "wq": ParamSpec((d_in, H, hd), ("mlp", "qheads", "head_dim"), "normal", si),
        "wk": ParamSpec((d_in, H, hd), ("mlp", "qheads", "head_dim"), "normal", si),
        "wv": ParamSpec((d_in, H, hd), ("mlp", "qheads", "head_dim"), "normal", si),
        "w_if": ParamSpec((d_in, 2 * H), ("mlp", None), "normal", si),
        "b_if": ParamSpec((2 * H,), (None,), "zeros"),
        "o_norm": ParamSpec((H, hd), ("qheads", "head_dim"), "ones"),
        "wo": ParamSpec((H, hd, d), ("qheads", "head_dim", "embed"), "normal",
                        si),
    }
    if cfg.mlstm_proj_factor:
        # pre-up-projection + swish output gate
        specs["w_up"] = ParamSpec((d, d_in), ("embed", "mlp"), "normal", s)
        specs["w_gate"] = ParamSpec((d, d_in), ("embed", "mlp"), "normal", s)
    return specs


def _mlstm_in(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Block input -> (cell input u, output gate z or None)."""
    if cfg.mlstm_proj_factor:
        u = torch.einsum("bsd,de->bse", x, p["w_up"])
        z = torch.einsum("bsd,de->bse", x, p["w_gate"])
        return u, z
    return x, None


def _mlstm_gates(p: dict, x: torch.Tensor):
    """(input gate, log forget gate), both f32 ``[B, S, H]``."""
    return _gate_acts(torch.einsum("bsd,dg->bsg", x, p["w_if"]) + p["b_if"])


def _gate_acts(gates: torch.Tensor):
    H = gates.shape[-1] // 2
    i_g = gates[..., :H].float()                        # input (log-space)
    logf = F.logsigmoid(gates[..., H:].float())         # forget
    return i_g, logf


def _mlstm_qkv(p: dict, cfg: ModelConfig, u: torch.Tensor):
    hd = _mlstm_dims(cfg)[1]
    q = torch.einsum("bsd,dnh->bsnh", u, p["wq"]) / math.sqrt(hd)
    k = torch.einsum("bsd,dnh->bsnh", u, p["wk"]) / math.sqrt(hd)
    v = torch.einsum("bsd,dnh->bsnh", u, p["wv"])
    return q, k, v


#: the mLSTM leaves over ``d_in`` and the dim each holds it on:
#: column-parallel (``w_up``, ``w_gate``) and row-parallel (the rest) where
#: the rules split ``d_in`` over ``model``
_D_IN = {"w_up": 1, "w_gate": 1, "wq": 0, "wk": 0, "wv": 0, "w_if": 0}


def _mlstm_proj(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x ``[B, S, d]`` -> (the leaves the cell and the output read, q, k, v
    ``[B, S, H, hd]``, input gate, log forget gate (f32 ``[B, S, H]``),
    the output gate or ``None``); under tensor parallelism over ``d_in``
    q, k, v and the gates are summed over ``model`` from this rank's
    columns and the output gate is gathered whole (module docstring)."""
    check_heads(cfg, "mlstm")
    split = _split_over_model(cfg, "mlstm")
    if not split:
        u, z_gate = _mlstm_in(p, cfg, x)
        q, k, v = _mlstm_qkv(p, cfg, u)
        return (p, q, k, v, *_mlstm_gates(p, u), z_gate)
    H, hd, _ = _mlstm_dims(cfg)
    B, S, _ = x.shape
    group = active_ctx().model_group()
    x = C.copy_to_model(x, group)
    if cfg.mlstm_proj_factor:
        u, z_gate = _mlstm_in(p, cfg, x)
    else:
        n = p["wq"].shape[0]
        r = active_ctx().mesh.coordinate()["model"]
        u, z_gate = x[..., r * n:(r + 1) * n], None
    # the partial products in f32, rounded once after the sum as the
    # whole contraction is (the gates go through exponentials)
    uf = u.float()
    part = torch.cat([torch.einsum("bsd,dnh->bsnh", uf, p[w].float()).reshape(
        B, S, H * hd) for w in ("wq", "wk", "wv")]
        + [torch.einsum("bsd,dg->bsg", uf, p["w_if"].float())], dim=-1)
    q, k, v, gates = torch.split(
        C.reduce_from_model(part, group).to(x.dtype),
        [H * hd] * 3 + [2 * H], dim=-1)
    q = q.reshape(B, S, H, hd) / math.sqrt(hd)
    k = k.reshape(B, S, H, hd) / math.sqrt(hd)
    if z_gate is not None:
        z_gate = C.gather(z_gate, group, 2)
    return (p, q, k, v.reshape(B, S, H, hd), *_gate_acts(gates + p["b_if"]),
            z_gate)


def _mlstm_cell(C, n, m, qf, kf, vf, it, lft):
    """One stabilised step, all f32.  C ``[B, H, hd, hd]``, n / q / k / v
    ``[B, H, hd]``, m / gates ``[B, H]`` -> (C, n, m, y ``[B, H, hd]``)."""
    m_new = torch.maximum(lft + m, it)                  # stabilizer
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(lft + m - m_new)
    C = C * f_s[..., None, None] + i_s[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = n * f_s[..., None] + i_s[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))[..., None]
    return C, n, m_new, num / den


def _mlstm_out(p: dict, cfg: ModelConfig, y: torch.Tensor,
               z_gate: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """y ``[B, S, H, hd]`` f32 -> the block's output ``[B, S, d]``."""
    B, S, H, hd = y.shape
    y = y * p["o_norm"].float()[None, None]
    if z_gate is not None:
        y = y * F.silu(z_gate.float()).reshape(B, S, H, hd)
    return out_proj(y.to(dtype), p["wo"])


def mlstm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Stabilized mLSTM over the sequence, a loop over time with f32
    states from zero.  x ``[B, S, d]``."""
    B, S, _ = x.shape
    H, hd, _ = _mlstm_dims(cfg)
    p, q, k, v, i_g, logf, z_gate = _mlstm_proj(p, cfg, x)
    q, k, v = q.float(), k.float(), v.float()
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        C, n, m, y = _mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t],
                                 i_g[:, t], logf[:, t])
        ys.append(y)
    return _mlstm_out(p, cfg, torch.stack(ys, dim=1), z_gate, x.dtype)


class MLSTMState(NamedTuple):
    C: torch.Tensor       # [B, H, hd, hd] f32
    n: torch.Tensor       # [B, H, hd] f32
    m: torch.Tensor       # [B, H] f32


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> MLSTMState:
    """Zero f32 mLSTM state on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    H, hd, _ = _mlstm_dims(cfg)
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        m=torch.zeros((batch, H), dtype=torch.float32, device=device))


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """x ``[B, 1, d]``, one step of :func:`mlstm_forward`'s loop.  Writes
    the new ``C``, ``n`` and ``m`` into ``state``'s tensors IN PLACE (the
    reference returns a new state) and returns the same ``state``."""
    p, q, k, v, i_g, logf, z_gate = _mlstm_proj(p, cfg, x)
    q, k, v = (t[:, 0].float() for t in (q, k, v))
    C, n, m, y = _mlstm_cell(state.C, state.n, state.m, q, k, v,
                             i_g[:, 0], logf[:, 0])
    out = _mlstm_out(p, cfg, y[:, None], z_gate, x.dtype)
    state.C.copy_(C)
    state.n.copy_(n)
    state.m.copy_(m)
    return out, state


# ================================================================== sLSTM

def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, hd = _slstm_dims(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        # 4 gates (i, f, z, o) input + block-diag recurrent weights
        "w_x": ParamSpec((d, 4, H, hd), ("embed", None, "qheads", "head_dim"),
                         "normal", s),
        "w_r": ParamSpec((4, H, hd, hd), (None, "qheads", "head_dim", None),
                         "normal", 1.0 / math.sqrt(hd)),
        "b": ParamSpec((4, H, hd), (None, "qheads", "head_dim"), "zeros"),
        "wo": ParamSpec((H, hd, d), ("qheads", "head_dim", "embed"), "normal",
                        1.0 / math.sqrt(d)),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor       # [B, H, hd] f32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> SLSTMState:
    """Zero f32 sLSTM state on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    H, hd = _slstm_dims(cfg)
    return SLSTMState(*(torch.zeros((batch, H, hd), dtype=torch.float32,
                                    device=device) for _ in range(4)))


def _slstm_step(p: dict, state: SLSTMState,
                xg: torch.Tensor) -> tuple[SLSTMState, torch.Tensor]:
    """xg ``[B, 4, H, hd]`` pre-activations from the input; the recurrence
    is added here, in f32."""
    c, n, h, m = state
    # [1, H, B, k] x [4, H, k, v] -> [4, H, B, v], batched over (gate,
    # head) on w_r's own layout (an einsum would copy it permuted)
    rec = torch.matmul(h.transpose(0, 1)[None], p["w_r"].float()).permute(
        2, 0, 1, 3)
    g = xg.float() + rec + p["b"].float()[None]
    i_t, f_t, z_t, o_t = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * torch.tanh(z_t)
    n = f_s * n + i_s
    h = torch.sigmoid(o_t) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new), h


def _slstm_in(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, d]`` -> gate pre-activations ``[B, S, 4, H, hd]``."""
    d, g, H, hd = p["w_x"].shape
    return torch.matmul(x, p["w_x"].reshape(d, g * H * hd)).reshape(
        *x.shape[:2], g, H, hd)


def slstm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """sLSTM over the sequence, a loop over time with f32 states from
    zero.  x ``[B, S, d]``."""
    B, S, _ = x.shape
    check_heads(cfg, "slstm")
    xg = _slstm_in(p, x).float()
    # the f32 casts of the step, made once for the whole loop
    pf = {"w_r": p["w_r"].float(), "b": p["b"].float()}
    st = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        st, h = _slstm_step(pf, st, xg[:, t])
        hs.append(h)
    return out_proj(torch.stack(hs, dim=1).to(x.dtype), p["wo"])


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """x ``[B, 1, d]``, one step.  Writes the new ``c``, ``n``, ``h`` and
    ``m`` into ``state``'s tensors IN PLACE and returns the same
    ``state``."""
    check_heads(cfg, "slstm")
    new, h = _slstm_step(p, state, _slstm_in(p, x)[:, 0])
    for old, t in zip(state, new):
        old.copy_(t)
    return out_proj(h.to(x.dtype)[:, None], p["wo"]), state
