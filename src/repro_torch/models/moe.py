"""Mixture-of-Experts block with expert parallelism (port of
``repro.models.moe``).

Two dispatch paths, chosen as the reference chooses them.  The **one-hot
path** (decode, small token counts, no mesh) is the Switch-style dispatch
einsum: each (token, slot) pair takes the next free row of its expert's
buffer, up to a capacity of ``ceil(T * k / E * capacity_factor)`` rows
for the call's T tokens; pairs past it are dropped (they ride the
residual).  The **a2a path** (an active sharding context whose model axis
M divides S, with B * S >= 4 M) runs on each rank of the mesh: the rank
takes its block of the tokens, buckets its (token, slot) pairs by
destination expert shard with a capacity, exchanges the buckets with an
all-to-all over the model group, buckets what it received by local expert
with a second capacity, runs its E / M experts, and sends the rows back
(:func:`_moe_a2a_local`).  Expert weights are this rank's shards (the
expert dim over ``model``, optionally dim 1 over ``expert_mlp``'s data
axes, FSDP, all-gathered inside the block).  The collectives are
``repro_torch.distributed.collectives`` functions whose backwards give
every leaf replicated over ``model`` its full gradient on every model rank.

**The one-hot path on a mesh of more than one rank** (decode under a
mesh, where S = 1 never meets the a2a rule for M > 1, and training
where M does not divide S or the batch holds fewer than 4 M tokens):
the ranks gather the tokens of the batch axes, so each routes the global
batch (capacity, dropped pairs and the load-balance means are the
reference's), runs its expert shards on the pairs routed to them and
reduces the activations, never the weights: under FSDP expert storage
(dim 1 of ``wi`` / ``wg`` over the data axes, that is ``d``, and of
``wo``, that is ``f``) the partial hidden ``h`` over those axes before
the activation, then the partial output over them and over ``model``.
Each rank keeps its rows (:func:`_moe_one_hot_ranks`).  Under grad each
collective carries a stated backward, so that after the train step's
sum over the batch axes (``train.step._reduce_grads``, which divides by
their size) every leaf's gradient is the global loss's, each rank's loss
counted once: the row gather reduce-scatters each row's gradient back to
its rank; the output's sum over the expert group sums the gradient over
the group's batch axes only (ranks along ``model`` hold the same rows
and the same loss); the expert inputs and the gates sum their gradient
over the expert group and keep a share of it, one part per rank of the
group with other rows (``collectives.share_grad``).  The router and
``lb``, computed whole on every rank from the global tokens, then give
each rank its share, which the train step sums once.

The one-hot einsum costs O(T * E * cap * d): at a 4096-token prefill of 64
experts that is petaflops of multiplications by zero.  The port computes
both paths' functions by index.  The running count of each expert over the
flattened (token, slot) pairs in token-major order gives each pair its
row, so the same pairs are dropped; kept pairs are copied into an
``[E, cap, d]`` buffer (dropped ones into a spare row that is cut off),
the experts run as batched products, and each pair reads its row back,
weighted by its gate value in the compute dtype and summed over the k
slots.  Every shape is static (no ``nonzero``, no boolean-mask indexing,
no host sync), so a decode step with MoE blocks can be captured in a CUDA
graph.  The a2a path keeps the reference's buckets, capacities and
drop slots, so it keeps and drops the same pairs.  No TPU kernel computes
any of this; it is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import active_ctx
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


def _gates(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
           batch_group=None):
    """Router in f32: (weights ``[T, k]`` f32, expert indices ``[T, k]``,
    Switch load-balance loss ``E * sum_e f_e * P_e``).  With
    ``batch_group`` (the data-parallel ranks, each holding its own T
    tokens) the two means are taken over every rank's tokens; their
    backward passes each rank's gradient through unscaled, so the
    data-parallel mean of the ranks' gradients is the global loss's."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                  # [E] mean prob
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)   # [E] top-1 share
    if batch_group is not None:
        me, ce = C.all_mean(me, batch_group), C.all_mean(ce, batch_group)
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
    same expert before it in token-major order.  (The a2a path groups
    by destination shard, then by local expert.)"""
    flat_e = gate_idx.reshape(-1)
    # the running count per expert along each expert's own row (a scan
    # along the last dimension: down the columns of the [T*k, E] one-hot
    # it runs one thread per expert)
    counts = F.one_hot(flat_e, n_experts).t().contiguous().cumsum(dim=1)
    pos = counts.gather(0, flat_e[None, :])[0] - 1
    return flat_e * cap + pos, pos < cap


def _expert_mlp(cfg: ModelConfig, xs: torch.Tensor, wi: torch.Tensor,
                wg: Optional[torch.Tensor], wo: torch.Tensor,
                part: Optional[tuple] = None) -> torch.Tensor:
    """xs ``[E, C, d]`` -> ``[E, C, d]`` through each expert.  ``part``
    (FSDP expert storage on a mesh): ``(group, d block, f block)``, where
    wi / wg hold the d block of their rows and wo the f block of its rows:
    xs is whole, the hidden is summed over ``group`` before the activation
    (its gradient too: each rank reads its f block of it), and the output
    is this rank's partial sum over f (the caller reduces it)."""
    def up(w):
        if part is None:
            return torch.bmm(xs, w)
        # partial over d
        return C.shared_sum(torch.bmm(xs[..., part[1]], w), part[0])

    h = up(wi)
    if wg is not None:
        h = F.silu(up(wg)) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    if part is not None:
        h = h[..., part[2]].contiguous()
    return torch.bmm(h, wo)


def _moe_indexed(cfg: ModelConfig, xt: torch.Tensor, gate_vals: torch.Tensor,
                 gate_idx: torch.Tensor, wi, wg, wo, *,
                 experts: Optional[slice] = None,
                 part: Optional[tuple] = None) -> torch.Tensor:
    """The one-hot path's function by index.  xt ``[T, d]``, gate_vals
    ``[T, k]`` in the compute dtype -> ``[T, d]``.  ``experts``: the
    experts wi / wg / wo hold (all by default); pairs routed elsewhere
    add nothing, so on a mesh the output is this rank's share of the sum
    (``part``: :func:`_expert_mlp`)."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    e0, e1 = (0, E) if experts is None else (experts.start, experts.stop)
    cap = capacity(cfg, T)
    row, keep = _slots(gate_idx, E, cap)
    if (e0, e1) != (0, E):
        keep = keep & (row >= e0 * cap) & (row < e1 * cap)
        row = row - e0 * cap
    spare = (e1 - e0) * cap                       # where dropped pairs go
    dest = torch.where(keep, row, spare)
    src = torch.arange(T * k, device=xt.device) // k          # pair's token
    buf = xt.new_zeros((spare + 1, d))
    buf.index_copy_(0, dest, xt[src])
    ye = _expert_mlp(cfg, buf[:spare].view(e1 - e0, cap, d), wi, wg, wo,
                     part)
    sel = ye.reshape(spare, d)[torch.where(keep, row, 0)]
    sel = sel * keep[:, None].to(xt.dtype)
    out = sel * gate_vals.reshape(-1)[:, None]
    return out.reshape(T, k, d).sum(dim=1)


def _moe_a2a_local(cfg: ModelConfig, xt: torch.Tensor,
                   gate_vals: torch.Tensor, gate_idx: torch.Tensor, wi, wg,
                   wo, *, model_group, n_shards: int,
                   fsdp_group=None) -> torch.Tensor:
    """One rank's share of the a2a path.  xt ``[T_loc, d]`` are this rank's
    tokens, gate_vals / gate_idx ``[T_loc, k]`` their routing; wi / wg / wo
    ``[E / M, ...]`` this rank's experts (dim 1 FSDP-sharded over
    ``fsdp_group`` when given) -> ``[T_loc, d]``."""
    if fsdp_group is not None:
        wi = C.gather_dim(wi, fsdp_group, 1)
        wo = C.gather_dim(wo, fsdp_group, 1)
        if wg is not None:
            wg = C.gather_dim(wg, fsdp_group, 1)

    T_loc, d = xt.shape
    E, k, M = cfg.n_experts, cfg.top_k, n_shards
    E_loc = E // M
    cap = max(int(math.ceil(T_loc * k / M * cfg.capacity_factor)), 1)

    flat_e = gate_idx.reshape(-1)                       # [T_loc*k] global ids
    dest = torch.div(flat_e, E_loc, rounding_mode="floor")
    local_e = flat_e - dest * E_loc                     # id on that shard
    # bucket by destination shard: row dest * cap + pos, pos < cap kept
    row, keep = _slots(dest, M, cap)
    spare = M * cap                                     # the drop slot
    slot = torch.where(keep, row, spare)
    src = torch.arange(T_loc * k, device=xt.device) // k
    send_x = xt.new_zeros((spare + 1, d)).index_copy(0, slot, xt[src])
    send_e = torch.full((spare + 1,), E_loc, dtype=local_e.dtype,
                        device=xt.device).index_copy(0, slot, local_e)

    recv_x = C.all_to_all(send_x[:spare], model_group)  # [M*cap, d]
    recv_e = C.all_to_all(send_e[:spare], model_group)  # E_loc = empty slot

    # bucket what arrived by local expert (empty slots are class E_loc)
    R = M * cap
    cap2 = max(int(math.ceil(R / E_loc * cfg.capacity_factor)), 1)
    row2, fits = _slots(recv_e, E_loc + 1, cap2)
    keep2 = fits & (recv_e < E_loc)
    spare2 = E_loc * cap2
    buf = recv_x.new_zeros((spare2 + 1, d)).index_copy(
        0, torch.where(keep2, row2, spare2), recv_x)
    yb = _expert_mlp(cfg, buf[:spare2].view(E_loc, cap2, d), wi, wg, wo)
    y_rows = yb.reshape(spare2, d)[torch.where(keep2, row2, 0)]
    y_rows = y_rows * keep2[:, None].to(xt.dtype)

    back = C.all_to_all(y_rows, model_group)            # [M*cap, d]
    sel = back[torch.where(keep, row, 0)] * keep[:, None].to(xt.dtype)
    weights = gate_vals.reshape(-1).to(xt.dtype)
    return (sel * weights[:, None]).reshape(T_loc, k, d).sum(dim=1)


def moe_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              batch_axes: Optional[tuple] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, load-balance loss, f32 scalar).

    Without an active sharding context (or with too few tokens for the
    model axis), the one-hot path.  Under one, the a2a path: ``x`` is this
    rank's block of the global batch (its rows along the batch axes,
    replicated over ``model``) and the expert leaves are this rank's
    shards (``ShardingCtx.expert_split``); the reference's rule reads the
    global batch, B times the batch axes' size.  ``batch_axes``: the axes
    ``x``'s rows are split over, where they are not the rules' (a decode
    batch too small to split: ``()``).  Where the rule picks the one-hot
    path under a mesh of more than one rank, :func:`_moe_one_hot_ranks`."""
    B, S, d = x.shape
    ctx = active_ctx()
    wi, wo, wg = p["wi"], p["wo"], p.get("wg")

    use_a2a = False
    if ctx is not None:
        if batch_axes is None:
            batch_axes = ctx.batch_axes()
        M = ctx.axis_size("model")
        n_batch = math.prod(ctx.axis_size(a) for a in batch_axes)
        use_a2a = S % max(M, 1) == 0 and B * n_batch * S >= 4 * M

    if not use_a2a:
        if ctx is not None and math.prod(ctx.mesh.axis_sizes) > 1:
            return _moe_one_hot_ranks(p, cfg, x, ctx, batch_axes)
        xt = x.reshape(B * S, d)
        gate_vals, gate_idx, lb = _gates(cfg, xt, p["router"])
        y = _moe_indexed(cfg, xt, gate_vals.to(x.dtype), gate_idx, wi, wg,
                         wo)
        return y.reshape(B, S, d), lb

    mesh = ctx.mesh
    fsdp_axes = ctx.fsdp_axes()
    model_group = mesh.group(("model",))
    xt = x.reshape(B * S, d)
    gate_vals, gate_idx, lb = _gates(cfg, xt, p["router"],
                                     mesh.group(batch_axes))
    # this rank's tokens: block m of its batch rows, which is block
    # (batch index) * M + m of the global tokens, as P((*batch, "model"))
    xt_loc = C.split(xt, model_group)
    gv_loc = C.split(gate_vals.to(x.dtype), model_group)
    gi_loc = C.split(gate_idx, model_group)
    yt = _moe_a2a_local(
        cfg, xt_loc, gv_loc, gi_loc, wi, wg, wo, model_group=model_group,
        n_shards=M, fsdp_group=mesh.group(fsdp_axes) if fsdp_axes else None)
    return C.gather(yt, model_group).reshape(B, S, d), lb


def _moe_one_hot_ranks(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx,
                       batch_axes: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot path on a mesh of more than one rank.  ``x`` ``[B, S,
    d]`` is this rank's rows (split over ``batch_axes``, replicated over
    the rest), the expert leaves its shards; the router is whole.  Every
    rank routes the global tokens, :func:`_moe_indexed` gives its experts'
    share of each pair it keeps, and the shares are summed over the axes
    the experts are split over.  The backwards are the module
    docstring's."""
    B, S, d = x.shape
    mesh = ctx.mesh
    xt = x.reshape(B * S, d)
    batch_group = mesh.group(batch_axes) if batch_axes else None
    if batch_group is not None:
        xt = C.gather_dim(xt, batch_group, 0)            # every rank's rows
    gate_vals, gate_idx, lb = _gates(cfg, xt, p["router"])
    gate_vals = gate_vals.to(x.dtype)
    # this rank's experts, and its blocks of d (wi, wg) and f (wo)
    specs = moe_specs(cfg)
    sl_i = mesh.local_slices(ctx.spec(specs["wi"].logical, specs["wi"].shape),
                             specs["wi"].shape)
    sl_o = mesh.local_slices(ctx.spec(specs["wo"].logical, specs["wo"].shape),
                             specs["wo"].shape)
    split = ctx.layout(specs["wi"].logical, specs["wi"].shape)
    part = (mesh.group(mesh.in_order(split[1])), sl_i[1], sl_o[1]) \
        if split[1] else None
    axes = mesh.in_order(split[0] + split[1])
    group = mesh.group(axes) if axes else None
    # the axes of the expert group along which the rows (and losses) differ
    rows_axes = tuple(a for a in axes if a in batch_axes)
    xt_e = xt
    if group is not None:
        parts = math.prod(mesh.shape[a] for a in rows_axes)
        xt_e = C.share_grad(xt, group, parts)
        gate_vals = C.share_grad(gate_vals, group, parts)
    y = _moe_indexed(cfg, xt_e, gate_vals, gate_idx, p["wi"], p.get("wg"),
                     p["wo"], experts=sl_i[0], part=part)
    if group is not None:
        y = C.sum_partials(y, group,
                           mesh.group(rows_axes) if rows_axes else None)
    if batch_group is not None:
        i = C.group_rank(batch_group)
        y = y[i * B * S:(i + 1) * B * S]
    return y.reshape(B, S, d), lb
