"""On-device (PyTorch) transfer simulator: event-driven and round-synchronous.

The port's counterpart of ``repro.core.jax_sim``: the same three engines
for the MDTP and static-chunking policies (one persistent connection per
server, constant per-server bandwidth with an optional single throttle
breakpoint, optional per-chunk lognormal jitter, optional per-chunk fault
injection, request pipelining, the hedged endgame and a decode term),
with the same arithmetic step for step.

Lanes
-----
PyTorch has no ``vmap`` over a data-dependent loop, so every core runs a
**batch of lanes**: each input carries a leading ``[B]`` lane axis
(bandwidths ``[B, N]``, chunk geometry, file size and seed ``[B]``), and
every field of the loop state does too.  One lane is one transfer; a
(scenario × C, L × seed) sweep is one lane batch.  The loop runs on the
host, one batched step per iteration:

``engine="event"`` (:func:`simulate_core`)
    Retires ONE chunk per lane per step: a per-lane ``argmin`` over
    servers, then one-hot ``torch.where`` updates (at N of 4-16 a one-hot
    select is cheaper than scatter).  O(#chunks) steps; exact event
    ordering; the only engine faithful for ``mode="static"``.

``engine="round"`` (:func:`simulate_round_core`)
    Completes every in-flight chunk of a lane and allocates the next full
    round vectorized over servers (``torch_alloc.grant``).  O(#rounds)
    steps.

``engine="scan"`` (:func:`simulate_scan_core`)
    The same round step for a fixed ``SimConfig.max_rounds`` trip count,
    reverse-differentiable under ``torch.autograd`` (pair with
    ``SimConfig(exact_sizes=False)``).  A drained lane is a fixed point of
    the round step, so the loop stops once every lane has drained: the
    steps it skips would change no value and no gradient.  A transfer that
    outruns ``max_rounds`` reports ``total_time = inf``.

In the two ``while`` engines a finished lane keeps its whole state (its
iteration count included), as ``vmap`` of ``lax.while_loop`` keeps it,
and ``SimConfig.max_iters`` applies per lane: the event core masks every
step of a finished lane; a drained lane is a fixed point of the round
step, so the round core masks only from step ``max_iters`` on.  The host
asks whether any lane is still live only every ``CHECK_EVERY`` steps:
steps on finished lanes are no-ops, so a late check costs launches, not
correctness.

Randomness
----------
``jax.random`` streams cannot be reproduced, so parity with the reference
is exact only without jitter and faults.  Draws come from a counter-based
32-bit hash keyed by (seed, step, server, stream), in int64 arithmetic on
16-bit halves (no signed overflow), mapped to uniforms and, by Box-Muller
in float64, to normals.  A lane therefore draws the same numbers whatever
else its batch holds, and the same numbers on the CPU and on the card.  As
in the reference, fault draws are made only when a fault rate is set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .._device import resolve_device
from .torch_alloc import (
    ChunkArrays,
    ChunkParamsLike,
    as_chunk_arrays,
    chunk_sizes,
    grant,
)

__all__ = [
    "SimConfig",
    "JaxSimResult",
    "simulate_core",
    "simulate_round_core",
    "simulate_scan_core",
    "resolve_engine",
    "simulate_transfer",
    "simulate_static",
]

#: steps between the host's checks for a live lane (one sync each)
CHECK_EVERY = 16

_F32 = torch.float32


class SimConfig(NamedTuple):
    """Simulation parameters that shape the loop (see the reference's
    ``SimConfig`` for each field's model)."""

    max_iters: int = 100_000
    #: lognormal sigma per chunk; 0 = deterministic
    jitter: float = 0.0
    #: lognormal sigma applied ONCE per simulation to every server's RTT
    rtt_jitter: float = 0.0
    #: trip count of the ``engine="scan"`` core; must cover
    #: ``ceil(file_size / L) + 2``, else ``total_time = inf``
    max_rounds: int = 1024
    #: False = continuous allocator relaxation (skip ``torch.round``) so
    #: the scan core is usefully differentiable in (C, L)
    exact_sizes: bool = True
    #: per-connection request pipeline depth of the modeled client
    pipeline_depth: int = 1
    #: per-chunk probability a chunk is lost (full duration, no credit,
    #: re-fetched)
    loss_rate: float = 0.0
    #: per-chunk probability a chunk fails verification (same dynamics)
    corruption_rate: float = 0.0
    #: endgame hedging quantile of the modeled client (round/scan engines);
    #: 0 disables
    hedge_quantile: float = 0.0
    #: client-side decode rate (decoded bytes/s); 0 disables the term
    decode_bytes_per_s: float = 0.0


class JaxSimResult(NamedTuple):
    """Per-lane results (named after the reference's result type).

    ``total_time`` is +inf for a lane that did NOT complete within its
    engine's bound (``max_iters``, or the scan engine's ``max_rounds``)."""

    total_time: torch.Tensor          # [B] f32
    bytes_per_server: torch.Tensor    # [B, N] f32
    requests_per_server: torch.Tensor  # [B, N] i32
    iters: torch.Tensor               # [B] i32


class _State(NamedTuple):
    t_free: torch.Tensor      # [B, N] next time each server is free (inf = retired)
    th: torch.Tensor          # [B, N] observed throughput (0 = unprobed)
    cursor: torch.Tensor      # [B] bytes assigned
    t_done: torch.Tensor      # [B] latest completion seen
    pending: torch.Tensor     # [B, N] in-flight chunk size (0 = none)
    pending_dt: torch.Tensor  # [B, N] in-flight chunk duration
    pending_ok: torch.Tensor  # [B, N] bool, in-flight chunk will verify/arrive
    bytes_srv: torch.Tensor   # [B, N]
    reqs: torch.Tensor        # [B, N] i32
    it: torch.Tensor          # [B] i32 (also the lane's draw counter)


class _Lanes(NamedTuple):
    """Loop constants of one core call."""

    bw0: torch.Tensor         # [B, N]
    throttle_t: torch.Tensor  # [B, N]
    bw1: torch.Tensor         # [B, N]
    rtt: torch.Tensor         # [B, N], RTT jitter applied
    chunk: ChunkArrays        # [B] each
    file_size: torch.Tensor   # [B]
    seed_hash: torch.Tensor   # [B] int64, the hashed seed
    ok_all: torch.Tensor      # [B, N] bool, all True
    later: torch.Tensor       # [N, N] bool, [i, j] = j < i (index ties)
    zero: torch.Tensor        # f32 scalars: operands of maximum/minimum/div
    eps9: torch.Tensor
    eps12: torch.Tensor
    decode_bw: torch.Tensor


# ----------------------------------------------------------------- draws

_M32 = 0xFFFFFFFF
_STREAM_BW, _STREAM_FAULT, _STREAM_RTT = 1, 2, 3


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x < 2**32``, on 16-bit halves so no
    int64 product exceeds 2**48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix (xorshift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_hash(seed: torch.Tensor) -> torch.Tensor:
    seed = seed.to(torch.int64)
    return _mix32((seed & _M32) ^ _mix32(((seed >> 32) & _M32) ^ 0x5851F42D))


def _hash(seed_hash: torch.Tensor, counter: torch.Tensor,
          server: torch.Tensor, stream: int) -> torch.Tensor:
    """One 32-bit draw per (lane seed, counter, server, stream); the
    arguments broadcast."""
    x = _mix32(seed_hash ^ _mulmod32(counter.to(torch.int64) & _M32,
                                     0x9E3779B1))
    return _mix32(x ^ ((server * 8 + stream) & _M32))


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """float64 uniform in (0, 1) from a 32-bit draw."""
    return (h.to(torch.float64) + 0.5) * (1.0 / 4294967296.0)


def _normal(h: torch.Tensor) -> torch.Tensor:
    """float64 standard normal from a 32-bit draw (Box-Muller over it and a
    second, derived draw)."""
    u1 = _uniform(h)
    u2 = _uniform(_mix32(h ^ 0x68E31DA4))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * torch.pi) * u2)


def _lognormal_scale(h: torch.Tensor, sigma: float) -> torch.Tensor:
    """Mean-1 lognormal factor, computed in float64 and rounded once to
    float32 (so the CPU and the card agree)."""
    return torch.exp(_normal(h) * sigma - 0.5 * sigma**2).to(_F32)


def _draw_block(lanes: _Lanes, it: torch.Tensor, steps: int, n: int,
                cfg: SimConfig):
    """The draws of the next ``steps`` steps of every lane, in one batch:
    step ``j`` of a live lane runs at counter ``it + j`` (a live lane's
    counter advances by one a step), so pre-drawing a block gives exactly
    the numbers a per-step draw would.  Returns ``(bw_scale, ok_new)``,
    each ``[steps, B, N]`` or None when its draw is off."""
    p_fail = cfg.loss_rate + cfg.corruption_rate
    if cfg.jitter <= 0.0 and p_fail <= 0.0:
        return None, None
    dev = it.device
    counter = it.to(torch.int64)[None, :, None] + torch.arange(
        steps, device=dev)[:, None, None]
    server = torch.arange(n, device=dev)
    sh = lanes.seed_hash[None, :, None]
    scale = ok = None
    if cfg.jitter > 0.0:
        scale = _lognormal_scale(_hash(sh, counter, server, _STREAM_BW),
                                 cfg.jitter)
    if p_fail > 0.0:
        ok = _uniform(_hash(sh, counter, server, _STREAM_FAULT)) >= p_fail
    return scale, ok


def _apply_rtt_jitter(rtt: torch.Tensor, seed_hash: torch.Tensor,
                      cfg: SimConfig) -> torch.Tensor:
    """Scale every server's RTT by a mean-1 lognormal factor, once per
    simulation, from its own stream (independent of the per-chunk
    draws)."""
    if cfg.rtt_jitter <= 0.0:
        return rtt
    server = torch.arange(rtt.shape[-1], device=rtt.device)
    counter = torch.zeros((), dtype=torch.int64, device=rtt.device)
    h = _hash(seed_hash[:, None], counter, server, _STREAM_RTT)
    return rtt * _lognormal_scale(h, cfg.rtt_jitter)


# ----------------------------------------------------------------- model

def _chunk_duration(size, t0, rtt, bw0, throttle_t, bw1, lanes: _Lanes,
                    depth: int = 1, warm: Optional[torch.Tensor] = None,
                    decode: bool = False) -> torch.Tensor:
    """Time to fetch ``size`` bytes starting at ``t0`` on one server whose
    rate steps from ``bw0`` to ``bw1`` at ``throttle_t``.

    ``depth`` models the client's request pipelining: a ``warm`` server
    pays only the RTT residue not hidden behind its ``depth - 1`` in-flight
    bodies, ``max(0, rtt - (depth - 1) * body_time)``.  ``decode`` adds
    ``size / decode_bytes_per_s`` of compute.

    Elementwise.  The untaken branch is re-clamped to a finite value
    ("double where"): ``throttle_t`` is ``inf`` for unthrottled servers,
    and an ``inf - inf`` NaN in a discarded branch would otherwise poison
    the scan core's gradients.
    """
    zero, eps9 = lanes.zero, lanes.eps9
    t_start = t0 + rtt
    window = torch.maximum(throttle_t - t_start, zero)
    first = bw0 * window
    pre_only = size <= first
    window_safe = torch.where(pre_only, 0.0, window)
    first_safe = bw0 * window_safe
    dur_pre = size / torch.maximum(bw0, eps9)
    dur_post = window_safe + (size - first_safe) / torch.maximum(bw1, eps9)
    dur = torch.where(pre_only, dur_pre, dur_post)
    dur = torch.where(t_start >= throttle_t, size / torch.maximum(bw1, eps9),
                      dur)
    if decode:
        dur = dur + size / lanes.decode_bw
    if depth <= 1:
        return rtt + dur
    rtt_eff = torch.maximum(rtt - (depth - 1) * dur, zero)
    if warm is not None:
        rtt_eff = torch.where(warm, rtt_eff, rtt)
    return rtt_eff + dur


def _remaining(file_size: torch.Tensor, cursor: torch.Tensor,
               zero: torch.Tensor) -> torch.Tensor:
    """Unassigned bytes; float32 cursor residue below ~2 ulp of the file
    size counts as done."""
    remaining = torch.maximum(file_size - cursor, zero)
    eps = file_size * 3e-7 + 1.0
    return torch.where(remaining <= eps, 0.0, remaining)


def _freeze(live: torch.Tensor, new: _State, old: _State) -> _State:
    """Keep a finished lane's whole state, as ``vmap`` of a while loop
    does."""
    out = []
    for a, b in zip(new, old):
        m = live if a.dim() == 1 else live[:, None]
        out.append(torch.where(m, a, b))
    return _State(*out)


def _running(st: _State) -> torch.Tensor:
    """``[B]``: the lane still has a connection in flight (``t_free`` is
    never NaN, so ``< inf`` is ``isfinite`` in one op)."""
    return (st.t_free < torch.inf).any(-1)


def _live(st: _State, max_iters: int) -> torch.Tensor:
    return _running(st) & (st.it < max_iters)


def _event_step(st: _State, lanes: _Lanes, mode: str, cfg: SimConfig,
                scale, ok_new) -> _State:
    """One event per lane: the earliest-free server completes its chunk
    and asks for its next one.  Not a no-op on a finished lane: the
    caller freezes those."""
    n = st.t_free.shape[-1]
    i = st.t_free.argmin(-1, keepdim=True)                     # [B, 1]
    onehot = torch.arange(n, device=i.device) == i              # [B, N]

    def at(x):
        return x.gather(-1, i).squeeze(-1)

    now = at(st.t_free)
    zero = lanes.zero

    # 1) complete its in-flight chunk (if any) and observe throughput; a
    # faulted chunk credits nothing and rolls its range back
    size_done = at(st.pending)
    has_pending = size_done > 0.0
    ok_p = at(st.pending_ok)
    ok_i = has_pending & ok_p
    bad_i = has_pending & ~ok_p
    th_obs = size_done / torch.maximum(at(st.pending_dt), lanes.eps12)
    hit_ok = onehot & ok_i[:, None]
    th = torch.where(hit_ok, th_obs[:, None], st.th)
    bytes_srv = torch.where(hit_ok, st.bytes_srv + size_done[:, None],
                            st.bytes_srv)
    t_done = torch.where(ok_i, torch.maximum(st.t_done, now), st.t_done)
    cursor0 = st.cursor - torch.where(bad_i, size_done, 0.0)

    # 2) ask the allocator for the next request
    remaining = _remaining(lanes.file_size, cursor0, zero)
    size = at(chunk_sizes(th, remaining, lanes.chunk, mode=mode,
                          exact=cfg.exact_sizes))
    active = size > 0.0

    bw0, bw1 = at(lanes.bw0), at(lanes.bw1)
    if scale is not None:
        s = scale[:, 0]
        bw0, bw1 = bw0 * s, bw1 * s
    dt = _chunk_duration(size, now, at(lanes.rtt), bw0, at(lanes.throttle_t),
                         bw1, lanes, depth=cfg.pipeline_depth,
                         warm=at(st.reqs) > 0,
                         decode=cfg.decode_bytes_per_s > 0.0)

    if ok_new is None:
        pending_ok = torch.where(onehot, True, st.pending_ok)
    else:
        pending_ok = torch.where(
            onehot, torch.where(active, ok_new[:, 0], True)[:, None],
            st.pending_ok)
    t_free = torch.where(
        onehot, torch.where(active, now + dt, torch.inf)[:, None], st.t_free)
    pending = torch.where(onehot, torch.where(active, size, 0.0)[:, None],
                          st.pending)
    pending_dt = torch.where(onehot, torch.where(active, dt, 0.0)[:, None],
                             st.pending_dt)
    cursor = cursor0 + torch.where(active, size, 0.0)
    reqs = st.reqs + (onehot & active[:, None])
    return _State(t_free=t_free, th=th, cursor=cursor, t_done=t_done,
                  pending=pending, pending_dt=pending_dt,
                  pending_ok=pending_ok, bytes_srv=bytes_srv, reqs=reqs,
                  it=st.it + 1)


def _round_step(st: _State, lanes: _Lanes, mode: str, cfg: SimConfig,
                scale, ok_new) -> _State:
    """One MDTP round per lane: complete every in-flight chunk, observe all
    N throughputs, allocate the next full round in one vector draw.  A
    drained lane is a fixed point (all sizes 0, every ``t_free`` +inf)."""
    zero, eps9 = lanes.zero, lanes.eps9
    # 1) complete ALL in-flight chunks; faulted ones credit nothing and
    # roll their ranges back into the budget
    has_pending = st.pending > 0.0
    ok_v = has_pending & st.pending_ok
    bad_v = has_pending & ~st.pending_ok
    th = torch.where(ok_v, st.pending / torch.maximum(st.pending_dt,
                                                      lanes.eps12), st.th)
    bytes_srv = st.bytes_srv + torch.where(ok_v, st.pending, 0.0)
    t_done = torch.maximum(
        st.t_done, torch.where(ok_v, st.t_free, -torch.inf).amax(-1))
    cursor0 = st.cursor - torch.where(bad_v, st.pending, 0.0).sum(-1)

    # 2) one batched allocation for the whole round, with the time-aware
    # budget debit: server j's draws before server i's ask number
    # ceil(lag_ij / dur_j) (index tie-break for simultaneous asks)
    remaining = _remaining(lanes.file_size, cursor0, zero)
    alive = st.t_free < torch.inf
    sizes_est = chunk_sizes(th, remaining, lanes.chunk, mode=mode,
                            exact=cfg.exact_sizes)
    tf_safe = torch.where(alive, st.t_free, 0.0)
    warm = st.reqs > 0
    decode = cfg.decode_bytes_per_s > 0.0
    dur_est = _chunk_duration(sizes_est, tf_safe, lanes.rtt, lanes.bw0,
                              lanes.throttle_t, lanes.bw1, lanes,
                              depth=cfg.pipeline_depth, warm=warm,
                              decode=decode)
    lag = torch.maximum(tf_safe[:, :, None] - tf_safe[:, None, :], zero)
    tie = (tf_safe[:, :, None] == tf_safe[:, None, :]) & lanes.later
    counts = torch.ceil(lag / torch.maximum(dur_est, eps9)[:, None, :])
    counts = counts + tie
    granted, total = grant(torch.where(alive, sizes_est, 0.0), remaining,
                           counts, zero)
    active = granted > 0.0

    # 3) all N durations in one vector op; retired clocks clamped out
    now = tf_safe
    bw0, bw1 = lanes.bw0, lanes.bw1
    if scale is not None:
        bw0, bw1 = bw0 * scale, bw1 * scale
    dt = _chunk_duration(granted, now, lanes.rtt, bw0, lanes.throttle_t, bw1,
                         lanes, depth=cfg.pipeline_depth, warm=warm,
                         decode=decode)
    if cfg.hedge_quantile > 0.0:
        # hedged endgame: a straggler's chunk completes no later than the
        # rest of the fleet drains the budget plus the winner's RTT and
        # body time (see the reference's round step)
        t_fin = torch.where(active, now + dt, torch.inf)
        w = t_fin.argmin(-1, keepdim=True)                      # [B, 1]
        t_best = t_fin.amin(-1)
        q = torch.nanquantile(torch.where(active, dt, torch.nan),
                              cfg.hedge_quantile, dim=-1)
        eff_bw = torch.where(t_best[:, None] >= lanes.throttle_t,
                             lanes.bw1, lanes.bw0)
        if scale is not None:
            eff_bw = eff_bw * scale
        fleet_bw = torch.where(active, eff_bw, 0.0).sum(-1)
        others_bw = fleet_bw[:, None] - eff_bw
        remaining_after = torch.maximum(remaining - total, zero)
        t_drain = torch.where(
            others_bw > 0.0,
            t_best[:, None] + remaining_after[:, None]
            / torch.maximum(others_bw, eps9),
            torch.inf)
        hedge_fin = (t_drain + lanes.rtt.gather(-1, w)
                     + granted / torch.maximum(eff_bw.gather(-1, w), eps9))
        if decode:
            hedge_fin = hedge_fin + granted / lanes.decode_bw
        idx = torch.arange(dt.shape[-1], device=dt.device)
        straggler = active & (dt > q[:, None]) & (idx[None, :] != w)
        dt = torch.where(
            straggler,
            torch.minimum(dt, torch.maximum(hedge_fin - now, eps9)), dt)
    t_free = torch.where(active, now + dt, torch.inf)
    pending_ok = (torch.where(active, ok_new, True) if ok_new is not None
                  else lanes.ok_all)
    stepped = has_pending.any(-1) | active.any(-1)
    return _State(
        t_free=t_free, th=th, cursor=cursor0 + total, t_done=t_done,
        pending=torch.where(active, granted, 0.0),
        pending_dt=torch.where(active, dt, 0.0),
        pending_ok=pending_ok, bytes_srv=bytes_srv,
        reqs=st.reqs + active,
        it=st.it + stepped)


# ----------------------------------------------------------------- cores

def _init(bandwidth, rtt, throttle_t, throttle_bw, seed, chunk, file_size,
          config: SimConfig) -> tuple[_State, _Lanes]:
    dev = bandwidth.device
    b, n = bandwidth.shape

    def lane(x):
        return torch.as_tensor(x, dtype=_F32, device=dev).expand(b)

    seed_hash = _seed_hash(torch.as_tensor(seed, device=dev).expand(b))

    def scalar(v):
        return torch.tensor(v, dtype=_F32, device=dev)

    lanes = _Lanes(
        bw0=bandwidth.to(_F32), throttle_t=throttle_t.to(_F32),
        bw1=throttle_bw.to(_F32),
        rtt=_apply_rtt_jitter(rtt.to(_F32), seed_hash, config),
        chunk=ChunkArrays(*(lane(x) for x in chunk)),
        file_size=lane(file_size), seed_hash=seed_hash,
        ok_all=torch.ones((b, n), dtype=torch.bool, device=dev),
        later=torch.ones((n, n), dtype=torch.bool, device=dev).tril(-1),
        zero=scalar(0.0), eps9=scalar(1e-9), eps12=scalar(1e-12),
        decode_bw=scalar(config.decode_bytes_per_s))
    zeros = torch.zeros((b, n), dtype=_F32, device=dev)
    state = _State(
        t_free=zeros, th=zeros, cursor=zeros[:, 0], t_done=zeros[:, 0],
        pending=zeros, pending_dt=zeros,
        pending_ok=lanes.ok_all, bytes_srv=zeros, reqs=torch.zeros((b, n), dtype=torch.int32,
                                          device=dev),
        it=torch.zeros((b,), dtype=torch.int32, device=dev))
    return state, lanes


def _result(final: _State) -> JaxSimResult:
    """A lane is complete iff every connection retired (``t_free`` all
    +inf); a truncated lane reports ``inf``, never a fast time."""
    complete = ~torch.isfinite(final.t_free).any(-1)
    return JaxSimResult(
        total_time=torch.where(complete, final.t_done, torch.inf),
        bytes_per_server=final.bytes_srv,
        requests_per_server=final.reqs,
        iters=final.it)


def _run(step, state: _State, lanes: _Lanes, mode: str, cfg: SimConfig,
         bound: int, until, freeze_from: Optional[int] = None) -> _State:
    """Host loop: blocks of ``CHECK_EVERY`` steps (draws made per block),
    ``until(state)`` checked between blocks, at most ``bound`` steps.  From
    host step ``freeze_from`` on, lanes that are no longer live keep their
    state."""
    n = state.t_free.shape[-1]
    done = 0
    while done < bound:
        k = min(CHECK_EVERY, bound - done)
        scale, ok = _draw_block(lanes, state.it, k, n, cfg)
        for j in range(k):
            new = step(state, lanes, mode, cfg,
                       None if scale is None else scale[j],
                       None if ok is None else ok[j])
            if freeze_from is not None and done + j >= freeze_from:
                new = _freeze(_live(state, cfg.max_iters), new, state)
            state = new
        done += k
        if done < bound and bool(until(state)):
            break
    return state


def simulate_core(bandwidth, rtt, throttle_t, throttle_bw, seed,
                  chunk: ChunkArrays, file_size, *, mode: str,
                  config: SimConfig) -> JaxSimResult:
    """Event core over a lane batch: ``bandwidth``, ``rtt``, ``throttle_t``
    and ``throttle_bw`` are ``[B, N]`` float tensors on one device;
    ``seed``, ``file_size`` and each ``chunk`` field are ``[B]`` (or
    scalars, broadcast to every lane)."""
    state, lanes = _init(bandwidth, rtt, throttle_t, throttle_bw, seed,
                         chunk, file_size, config)
    final = _run(_event_step, state, lanes, mode, config,
                 config.max_iters + CHECK_EVERY,
                 lambda st: ~_live(st, config.max_iters).any(),
                 freeze_from=0)
    return _result(final)


def simulate_round_core(bandwidth, rtt, throttle_t, throttle_bw, seed,
                        chunk: ChunkArrays, file_size, *, mode: str,
                        config: SimConfig) -> JaxSimResult:
    """Round-synchronous core with early exit; same lane contract as
    :func:`simulate_core`; ``iters`` counts rounds, not events."""
    state, lanes = _init(bandwidth, rtt, throttle_t, throttle_bw, seed,
                         chunk, file_size, config)
    # a drained lane is a fixed point of the round step, and a lane's count
    # never exceeds the host's step index: only from step max_iters on can
    # a lane that is still running need freezing
    final = _run(_round_step, state, lanes, mode, config,
                 config.max_iters + CHECK_EVERY,
                 lambda st: ~_live(st, config.max_iters).any(),
                 freeze_from=config.max_iters)
    return _result(final)


def simulate_scan_core(bandwidth, rtt, throttle_t, throttle_bw, seed,
                       chunk: ChunkArrays, file_size, *, mode: str,
                       config: SimConfig) -> JaxSimResult:
    """Fixed-round-bound core: ``config.max_rounds`` round steps, no
    per-lane freeze, differentiable under ``torch.autograd`` in every
    float input (``chunk`` included; pair with ``exact_sizes=False``).
    Stops early once every lane has drained (a fixed point of the step)."""
    state, lanes = _init(bandwidth, rtt, throttle_t, throttle_bw, seed,
                         chunk, file_size, config)
    final = _run(_round_step, state, lanes, mode, config, config.max_rounds,
                 lambda st: ~_running(st).any())
    return _result(final)


#: Modes whose rounds complete in lockstep by construction (§IV: chunk
#: sizes equalize durations), i.e. where the round engines are faithful.
_ROUND_SYNC_MODES = ("proportional", "fast_get_large")

_CORES = {
    "event": simulate_core,
    "round": simulate_round_core,
    "scan": simulate_scan_core,
}


def resolve_engine(engine: str | None, mode: str) -> str:
    """Map ``engine=None``/``"auto"`` to the faithful default for ``mode``:
    ``"round"`` for the round-synchronous allocator modes, ``"event"`` for
    ``mode="static"``."""
    if engine in (None, "auto"):
        return "round" if mode in _ROUND_SYNC_MODES else "event"
    if engine not in _CORES:
        raise ValueError(
            f"unknown engine: {engine!r} (expected event|round|scan)")
    return engine


def _simulate(bandwidth, rtt, throttle_t, throttle_bw, seed, chunk,
              file_size, *, mode, config, engine) -> JaxSimResult:
    return _CORES[engine](bandwidth, rtt, throttle_t, throttle_bw, seed,
                          chunk, file_size, mode=mode, config=config)


def _prep(bandwidth, rtt, throttle_t, throttle_bw, device: torch.device):
    """Normalize scenario inputs to float32 tensors on ``device``, with
    rtt/throttle args broadcast to the bandwidth shape (``[N]`` or
    ``[S, N]``)."""
    def f32(x):
        return torch.as_tensor(x, dtype=_F32, device=device)

    bandwidth = f32(bandwidth)
    shape = bandwidth.shape
    rtt = f32(rtt).expand(shape)
    if throttle_t is None:
        throttle_t = torch.full(shape, torch.inf, dtype=_F32, device=device)
    else:
        throttle_t = f32(throttle_t).expand(shape)
    throttle_bw = bandwidth if throttle_bw is None else \
        f32(throttle_bw).expand(shape)
    return bandwidth, rtt, throttle_t, throttle_bw


def simulate_transfer(
    bandwidth,
    rtt,
    file_size: float,
    params: ChunkParamsLike,
    throttle_t=None,
    throttle_bw=None,
    seed: int = 0,
    config: SimConfig = SimConfig(),
    mode: str | None = None,
    engine: str | None = "event",
    device: Optional[Union[str, torch.device]] = None,
) -> JaxSimResult:
    """One MDTP transfer on ``device`` (default the card).  All array args
    are per-server ``[N]``; the result has no lane axis.

    ``engine``: ``"event"`` (default, exact event ordering), ``"round"``,
    ``"scan"``, or ``None``/``"auto"`` (``"round"`` unless
    ``mode="static"``).
    """
    dev = resolve_device(device)
    chunk, mode = as_chunk_arrays(params, mode, device=dev)
    engine = resolve_engine(engine, mode)
    bandwidth, rtt, throttle_t, throttle_bw = _prep(
        bandwidth, rtt, throttle_t, throttle_bw, dev)
    res = _simulate(bandwidth[None], rtt[None], throttle_t[None],
                    throttle_bw[None], seed, chunk,
                    torch.tensor(float(file_size), dtype=_F32, device=dev),
                    mode=mode, config=config, engine=engine)
    return JaxSimResult(*(x[0] for x in res))


def simulate_static(
    bandwidth,
    rtt,
    file_size: float,
    chunk_size: float,
    throttle_t=None,
    throttle_bw=None,
    seed: int = 0,
    config: SimConfig = SimConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> JaxSimResult:
    """Static-chunking transfer (Rodriguez baseline): the adaptive path
    with ``C == L == chunk`` under ``mode="static"``, always on the event
    engine (fixed chunks are not round-synchronous)."""
    c = float(chunk_size)
    return simulate_transfer(
        bandwidth, rtt, file_size, (c, c, c),
        throttle_t=throttle_t, throttle_bw=throttle_bw,
        seed=seed, config=config, mode="static", engine="event",
        device=device)
