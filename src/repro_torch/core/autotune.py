"""Automatic chunk-size selection, the paper's §VIII-A future work.

The port of ``repro.core.autotune``.  The on-device simulator
(``repro_torch.core.torch_sim``) carries a leading lane axis, so the
**entire** (scenario × C, L × Monte-Carlo seed) sweep is one lane batch:
one host loop of batched steps on the card, whatever the grid size.

The sweep runs on the round-synchronous core by default (O(#rounds) steps
instead of O(#chunks)), with ``engine="event"`` as the escape hatch back
to exact event ordering and ``engine="scan"`` for the fixed-trip-count
variant.  ``mode="static"`` always routes to the event core.

Beyond the grid: :func:`tune_chunk_params_grad` descends the
``torch.autograd`` gradient of the scan core's total time through a
continuous (C, L) relaxation.

The transfer client calls this with live throughput estimates to re-tune
chunk sizes between transfers (``MDTPClient.retune``).

Every entry point runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from .chunking import DEFAULT_MIN_CHUNK, MB, ChunkParams
from .torch_alloc import ChunkArrays
from .torch_sim import (
    _CORES as _ENGINE_CORES,
    SimConfig,
    _prep,
    _simulate,
    resolve_engine,
    simulate_scan_core,
)

__all__ = [
    "AutotuneResult",
    "GradTuneResult",
    "default_grid",
    "autotune_chunk_params",
    "autotune_batch",
    "sweep_scenarios",
    "contention_sweep",
    "swarm_sweep",
    "tune_chunk_params_grad",
]

Device = Optional[Union[str, torch.device]]


@dataclass(frozen=True)
class AutotuneResult:
    params: ChunkParams
    predicted_time: float
    grid: list[tuple[int, int]]          # (C, L) pairs evaluated
    predicted_times: list[float]         # same order as grid

    def as_table(self) -> str:
        lines = ["C(MB),L(MB),predicted_s"]
        for (c, l), t in zip(self.grid, self.predicted_times):
            lines.append(f"{c / MB:g},{l / MB:g},{t:.2f}")
        return "\n".join(lines)


def default_grid() -> list[tuple[int, int]]:
    """Paper Table II's grid: C in {2,4,8,16} MB x L/C in {2.5, 5, 10, 20}."""
    grid = []
    for c_mb in (2, 4, 8, 16):
        for ratio in (2.5, 5.0, 10.0, 20.0):
            grid.append((c_mb * MB, int(c_mb * ratio) * MB))
    return grid


def _sweep_lanes(bw, rtt, throttle_t, throttle_bw, file_size, grid_c, grid_l,
                 grid_min, seeds, *, mode, config, engine="round"):
    """``[S]`` scenarios × ``[G]`` grid × ``[K]`` seeds → ``[S, G, K]``
    total times, as ONE lane batch of ``S * G * K`` transfers."""
    s, n = bw.shape
    g, k = grid_c.shape[0], seeds.shape[0]
    b = s * g * k

    def per_scenario(x):          # [S, N] -> [B, N]
        return x[:, None, None, :].expand(s, g, k, n).reshape(b, n)

    def per_grid(x):              # [G] -> [B]
        return x[None, :, None].expand(s, g, k).reshape(b)

    res = _ENGINE_CORES[engine](
        per_scenario(bw), per_scenario(rtt), per_scenario(throttle_t),
        per_scenario(throttle_bw),
        seeds[None, None, :].expand(s, g, k).reshape(b),
        ChunkArrays(per_grid(grid_c), per_grid(grid_l), per_grid(grid_min)),
        file_size[:, None, None].expand(s, g, k).reshape(b),
        mode=mode, config=config)
    return res.total_time.reshape(s, g, k)


def _grid_arrays(grid, device) -> tuple[torch.Tensor, ...]:
    grid_c = torch.tensor([float(c) for c, _ in grid], dtype=torch.float32,
                          device=device)
    grid_l = torch.tensor([float(l) for _, l in grid], dtype=torch.float32,
                          device=device)
    grid_min = torch.full((len(grid),), float(DEFAULT_MIN_CHUNK),
                          dtype=torch.float32, device=device)
    return grid_c, grid_l, grid_min


def _sized_config(cfg: SimConfig, engine: str, grid, file_size) -> SimConfig:
    """For the scan engine, widen ``max_rounds`` to cover the sweep's
    worst case (smallest L, largest file): ``ceil(max_file / min_L) + 2``,
    inflated to ``need / (1 - p)`` plus slack under a per-chunk failure
    probability ``p`` (capped at 0.75)."""
    if engine != "scan":
        return cfg
    min_l = min(l for _, l in grid)
    need = int(np.ceil(float(np.max(file_size)) / float(min_l))) + 2
    p_fail = min(cfg.loss_rate + cfg.corruption_rate, 0.75)
    if p_fail > 0.0:
        need = int(np.ceil(need / (1.0 - p_fail))) + 8
    return cfg if cfg.max_rounds >= need else cfg._replace(max_rounds=need)


def _config(jitter=0.0, pipeline_depth=1, loss_rate=0.0, corruption_rate=0.0,
            hedge_quantile=0.0, decode_bytes_per_s=0.0) -> SimConfig:
    return SimConfig(jitter=jitter, pipeline_depth=pipeline_depth,
                     loss_rate=loss_rate, corruption_rate=corruption_rate,
                     hedge_quantile=hedge_quantile,
                     decode_bytes_per_s=decode_bytes_per_s)


def autotune_chunk_params(
    bandwidth: Sequence[float],
    rtt,
    file_size: int,
    grid: Sequence[tuple[int, int]] | None = None,
    jitter: float = 0.0,
    n_seeds: int = 1,
    mode: str = "proportional",
    engine: str | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Device = None,
) -> AutotuneResult:
    """Pick (C, L) minimizing simulated transfer time.

    The whole grid × seed sweep is one lane batch on ``device``.

    Args:
      bandwidth: per-server bytes/s estimates (live throughput observations).
      rtt: scalar or per-server request RTT in seconds.
      file_size: bytes.
      grid: candidate (C, L) pairs; default = paper Table II sweep.
      jitter: lognormal sigma; with ``n_seeds > 1`` times are averaged over
        seeds.
      engine: ``None`` resolves to the round-synchronous core; ``"event"``
        for exact per-event ordering, ``"scan"`` for the fixed trip count.
      pipeline_depth: the client's per-connection request pipeline depth.
      loss_rate / corruption_rate: observed per-chunk fault probabilities;
        pair with ``n_seeds > 1``.
      device: where the sweep runs (default the card).
    """
    dev = resolve_device(device)
    grid = list(grid or default_grid())
    times = sweep_scenarios(
        [list(bandwidth)], rtt, file_size, grid=grid, jitter=jitter,
        n_seeds=n_seeds, mode=mode, engine=engine,
        pipeline_depth=pipeline_depth, loss_rate=loss_rate,
        corruption_rate=corruption_rate, hedge_quantile=hedge_quantile,
        decode_bytes_per_s=decode_bytes_per_s, device=dev)[0]
    times = times.cpu().numpy().astype(np.float64)
    best = int(np.argmin(times))
    c, l = grid[best]
    return AutotuneResult(
        params=ChunkParams(initial_chunk=c, large_chunk=l, mode=mode),
        predicted_time=float(times[best]),
        grid=grid,
        predicted_times=[float(t) for t in times],
    )


def sweep_scenarios(
    bandwidth,
    rtt,
    file_size,
    grid: Sequence[tuple[int, int]] | None = None,
    throttle_t=None,
    throttle_bw=None,
    jitter: float = 0.0,
    n_seeds: int = 1,
    mode: str = "proportional",
    engine: str | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Device = None,
) -> torch.Tensor:
    """Seed-averaged predicted times for a batch of scenarios.

    Args:
      bandwidth: ``[S, N]`` bytes/s, one row per scenario.
      rtt: scalar, ``[N]``, or ``[S, N]`` seconds.
      file_size: scalar or ``[S]`` bytes (per-scenario object sizes).
      grid: candidate (C, L) pairs; default = paper Table II sweep.
      throttle_t / throttle_bw: optional ``[S, N]`` throttle breakpoints
        (time, post-throttle rate).
      engine: loop structure; ``None`` → round core.
      device: where the sweep runs (default the card).

    Returns:
      ``[S, G]`` float32 tensor (on ``device``) of seed-averaged predicted
      transfer times, every (scenario, C, L, seed) cell one lane of a
      single batch.
    """
    dev = resolve_device(device)
    grid = list(grid or default_grid())
    engine = resolve_engine(engine, mode)
    bw = torch.as_tensor(np.asarray(bandwidth, np.float64),
                         dtype=torch.float32, device=dev)
    if bw.dim() != 2:
        raise ValueError(
            f"bandwidth must be [S, N], got shape {tuple(bw.shape)}")
    bw, rtt, throttle_t, throttle_bw = _prep(
        bw, rtt, throttle_t, throttle_bw, dev)
    s = bw.shape[0]
    sizes = np.broadcast_to(np.asarray(file_size, np.float64), (s,)).copy()
    cfg = _sized_config(
        _config(jitter, pipeline_depth, loss_rate, corruption_rate,
                hedge_quantile, decode_bytes_per_s),
        engine, grid, sizes)
    grid_c, grid_l, grid_min = _grid_arrays(grid, dev)
    seeds = torch.arange(max(n_seeds, 1), device=dev)
    times_sgk = _sweep_lanes(
        bw, rtt, throttle_t, throttle_bw,
        torch.as_tensor(sizes, dtype=torch.float32,
                        device=dev),
        grid_c, grid_l, grid_min, seeds, mode=mode, config=cfg,
        engine=engine)
    return times_sgk.mean(-1)


def autotune_batch(
    bandwidth,
    rtt,
    file_size,
    grid: Sequence[tuple[int, int]] | None = None,
    throttle_t=None,
    throttle_bw=None,
    jitter: float = 0.0,
    n_seeds: int = 1,
    mode: str = "proportional",
    engine: str | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Device = None,
) -> list[AutotuneResult]:
    """Per-scenario chunk-size selection over an ``[S, N]`` scenario batch:
    an argmin over :func:`sweep_scenarios` per row (same order as the
    bandwidth rows)."""
    grid = list(grid or default_grid())
    times_sg = sweep_scenarios(
        bandwidth, rtt, file_size, grid=grid,
        throttle_t=throttle_t, throttle_bw=throttle_bw,
        jitter=jitter, n_seeds=n_seeds, mode=mode, engine=engine,
        pipeline_depth=pipeline_depth,
        loss_rate=loss_rate, corruption_rate=corruption_rate,
        hedge_quantile=hedge_quantile,
        decode_bytes_per_s=decode_bytes_per_s, device=device,
    ).cpu().numpy().astype(np.float64)

    results = []
    for row in times_sg:
        best = int(np.argmin(row))
        c, l = grid[best]
        results.append(AutotuneResult(
            params=ChunkParams(initial_chunk=c, large_chunk=l, mode=mode),
            predicted_time=float(row[best]),
            grid=grid,
            predicted_times=[float(t) for t in row],
        ))
    return results


def contention_sweep(
    bandwidth: Sequence[float],
    rtt,
    file_size,
    max_transfers: int = 4,
    ks: Sequence[int] | None = None,
    grid: Sequence[tuple[int, int]] | None = None,
    jitter: float = 0.0,
    n_seeds: int = 1,
    mode: str = "proportional",
    engine: str | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Device = None,
) -> dict[int, AutotuneResult]:
    """Per-contention-level chunk tuning: scenario ``k`` is the fleet under
    a fair ``k``-way split (every replica's bandwidth divided by ``k``, RTTs
    unchanged).  The whole (k, C, L, seed) lattice is one lane batch via
    :func:`autotune_batch`; ``file_size`` may be a scalar or one entry per
    ``k``."""
    ks = list(ks if ks is not None else range(1, max_transfers + 1))
    if not ks or any(k < 1 for k in ks):
        raise ValueError(f"contention levels must be >= 1, got {ks}")
    grid = list(grid or default_grid())
    bw = np.asarray(bandwidth, np.float64)
    if bw.ndim != 1:
        raise ValueError(f"bandwidth must be [N], got shape {bw.shape}")
    mat = np.stack([bw / k for k in ks])
    results = autotune_batch(
        mat, rtt, file_size, grid=grid, jitter=jitter, n_seeds=n_seeds,
        mode=mode, engine=engine, pipeline_depth=pipeline_depth,
        loss_rate=loss_rate, corruption_rate=corruption_rate,
        hedge_quantile=hedge_quantile,
        decode_bytes_per_s=decode_bytes_per_s, device=device)
    return dict(zip(ks, results))


def swarm_sweep(
    file_size,
    origin_bw: float,
    peer_bw: float | None = None,
    ns: Sequence[int] = (2, 4, 8),
    onset: float = 1.0,
    rtt=0.03,
    grid: Sequence[tuple[int, int]] | None = None,
    jitter: float = 0.0,
    n_seeds: int = 1,
    mode: str = "proportional",
    engine: str | None = None,
    pipeline_depth: int = 1,
    device: Device = None,
) -> dict[int, AutotuneResult]:
    """Per-swarm-size chunk tuning for peer-assisted broadcast.

    Scenario ``n`` is the fleet ONE of ``n`` restorers sees
    (:func:`repro_torch.core.scenarios.swarm_fleet`): the origin at a fair
    ``1/n`` share plus ``n - 1`` peer mirrors that come online mid-transfer
    (an UP-step throttle breakpoint).  The server COUNT changes with ``n``,
    so each swarm size is its own grid × seed batch.
    """
    from .scenarios import swarm_axes, swarm_fleet

    ns = sorted(set(int(n) for n in ns))
    if not ns or ns[0] < 1:
        raise ValueError(f"swarm sizes must be >= 1, got {ns}")
    grid = list(grid or default_grid())
    results: dict[int, AutotuneResult] = {}
    for n in ns:
        servers = swarm_fleet(n, origin_bw=origin_bw, peer_bw=peer_bw,
                              onset=onset, rtt=rtt)
        bw0, tt, tb = swarm_axes(servers)
        results[n] = autotune_batch(
            np.asarray([bw0]), rtt, file_size,
            throttle_t=np.asarray([tt]), throttle_bw=np.asarray([tb]),
            grid=grid, jitter=jitter, n_seeds=n_seeds, mode=mode,
            engine=engine, pipeline_depth=pipeline_depth,
            device=device)[0]
    return results


# --------------------------------------------------------------------------
# Gradient-based continuous (C, L) tuning on the differentiable scan core
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GradTuneResult:
    """Outcome of :func:`tune_chunk_params_grad`.

    ``final_grad`` is the (dT/dC, dT/dL) gradient at the adopted point,
    kept so callers can verify the scan core's differentiability: both
    entries finite, not both zero.
    """

    params: ChunkParams
    predicted_time: float
    loss_history: list[float]
    final_grad: tuple[float, float]

    @property
    def steps(self) -> int:
        return len(self.loss_history)


# -- shared z-space descent machinery (also used by repro_torch.core.online)
#
# (C, L) are parameterized as ``floor + exp(z)``: C floored at ``min_chunk``
# and L at ``file_size / (max_rounds - 2)``, which keeps the scan bound
# valid for every point the optimizer can visit.  z lives on the host as a
# float32 CPU tensor; each loss evaluation moves it to the device.

def _l_floor_for(min_chunk: float, file_size: float, max_rounds: int,
                 p_fail: float = 0.0) -> float:
    """With faults on (``p_fail > 0``) the useful-round budget shrinks by
    the expected forfeit fraction, so the L floor rises to keep the scan
    bound valid in expectation (fault-free callers are unchanged)."""
    rounds = max(max_rounds - 2, 1)
    if p_fail > 0.0:
        rounds = max(int(rounds * (1.0 - min(p_fail, 0.75))) - 2, 1)
    return max(float(min_chunk), float(file_size) / rounds)


def _z_init(init: tuple[float, float], min_chunk: float,
            l_floor: float) -> torch.Tensor:
    return torch.tensor([
        np.log(max(init[0] - min_chunk, 1.0)),
        np.log(max(init[1] - l_floor, 1.0)),
    ], dtype=torch.float32)


def _z_decode(z: torch.Tensor, min_chunk, l_floor):
    """Inverse of :func:`_z_init`: the point the loss evaluates."""
    return min_chunk + torch.exp(z[0]), l_floor + torch.exp(z[1])


def _value_and_grad(loss, device: torch.device):
    """``vg(z, *args) -> (loss value, dloss/dz)`` through
    ``torch.autograd``; ``z`` and the gradient are host float32 tensors."""
    def vg(z, *args):
        zd = z.detach().to(device).requires_grad_(True)
        val = loss(zd, *args)
        (g,) = torch.autograd.grad(val, zd, allow_unused=True)
        if g is None:
            g = torch.zeros_like(zd)
        return float(val.detach()), g.detach().cpu()

    return vg


def _adam_descend(vg, z: torch.Tensor, steps: int, lr: float, args=()):
    """Adam on ``vg(z, *args)`` with best-seen tracking.

    Returns ``(best_z, history)``: ``best_z`` is the lowest-loss iterate
    (never worse than the init), ``history`` the loss per step.  Stops
    early on a non-finite loss or gradient (the bad step is recorded but
    never adopted).  Float32 arithmetic on the host, as in the reference.
    """
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    history: list[float] = []
    best_z, best_t = z, float("inf")
    for t in range(1, max(steps, 1) + 1):
        val, g = vg(z, *args)
        history.append(val)
        if not np.isfinite(val) or not bool(torch.isfinite(g).all()):
            break
        if val < best_t:
            best_t, best_z = val, z
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        z = z - lr * mh / (torch.sqrt(vh) + adam_eps)
    return best_z, history


def _exact_time(params: ChunkParams, bw, rtt_a, throttle_t, throttle_bw,
                file_f, mode: str, pipeline_depth: int = 1,
                loss_rate: float = 0.0,
                corruption_rate: float = 0.0,
                hedge_quantile: float = 0.0,
                decode_bytes_per_s: float = 0.0) -> float:
    """Honest number for integer params: exact sizes, round core, no
    jitter; the metric both gradient tuners report and compare on (under
    faults, at the fixed seed 0 so init/final compare on the same
    draws)."""
    res = _simulate(
        bw[None], rtt_a[None], throttle_t[None], throttle_bw[None], 0,
        ChunkArrays.from_params(params, bw.device), file_f,
        mode=mode, config=_config(0.0, pipeline_depth, loss_rate,
                                  corruption_rate, hedge_quantile,
                                  decode_bytes_per_s),
        engine="round")
    return float(res.total_time[0])


def _finish_grad_tune(vg, vg_args, best_z, history,
                      init: tuple[float, float], min_chunk: int,
                      l_floor: float, mode: str,
                      bw, rtt_a, throttle_t, throttle_bw,
                      file_f, pipeline_depth: int = 1,
                      loss_rate: float = 0.0,
                      corruption_rate: float = 0.0,
                      hedge_quantile: float = 0.0,
                      decode_bytes_per_s: float = 0.0) -> GradTuneResult:
    """Round ``best_z`` to integer ``ChunkParams``, guarantee never-worse
    than ``init`` on the EXACT metric (rounding can cross a round-count
    jump), and report the (dT/dC, dT/dL) chain-rule gradient."""
    z0, z1 = float(best_z[0]), float(best_z[1])
    c_best = int(round(min_chunk + float(np.exp(z0))))
    l_best = int(round(l_floor + float(np.exp(z1))))
    params = ChunkParams(
        initial_chunk=max(c_best, min_chunk),
        large_chunk=max(l_best, min_chunk),
        min_chunk=min_chunk, mode=mode)
    t_final = _exact_time(params, bw, rtt_a, throttle_t, throttle_bw,
                          file_f, mode, pipeline_depth,
                          loss_rate, corruption_rate, hedge_quantile,
                          decode_bytes_per_s)
    init_params = ChunkParams(
        initial_chunk=max(int(round(init[0])), min_chunk),
        large_chunk=max(int(round(init[1])), min_chunk),
        min_chunk=min_chunk, mode=mode)
    t_init = _exact_time(init_params, bw, rtt_a, throttle_t, throttle_bw,
                         file_f, mode, pipeline_depth,
                         loss_rate, corruption_rate, hedge_quantile,
                         decode_bytes_per_s)
    if t_init < t_final:
        params, t_final = init_params, t_init
    # grad w.r.t. (C, L) via the chain rule through the floor+exp map:
    # dT/dC = dT/dz0 / exp(z0) etc.
    _, g = vg(best_z, *vg_args)
    g = g.numpy().astype(np.float64)
    final_grad = (g[0] / max(float(np.exp(z0)), 1e-30),
                  g[1] / max(float(np.exp(z1)), 1e-30))
    return GradTuneResult(
        params=params,
        predicted_time=t_final,
        loss_history=history,
        final_grad=(float(final_grad[0]), float(final_grad[1])),
    )


def tune_chunk_params_grad(
    bandwidth: Sequence[float],
    rtt,
    file_size: int,
    init: tuple[float, float] | None = None,
    steps: int = 60,
    lr: float = 0.05,
    mode: str = "proportional",
    min_chunk: int = DEFAULT_MIN_CHUNK,
    max_rounds: int = 1024,
    grid: Sequence[tuple[int, int]] | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Device = None,
) -> GradTuneResult:
    """Continuous (C, L) refinement: an autograd polish of the grid winner.

    Runs Adam on the **scan core** with the allocator's continuous
    relaxation (``SimConfig(exact_sizes=False)``), so total time is a.e.
    differentiable in the chunk geometry.

    Transfer time is a sawtooth in (C, L): smooth within a fixed round
    count, with downward jumps where the file packs into one fewer round.
    The pathwise gradient sees only the within-basin slope, so the tuner
    is a hybrid: the grid sweep picks the basin (``init=None`` runs it),
    gradient descent refines inside and near it, and best-seen tracking
    guarantees the result is never worse than the init.

    Returns the best-seen point as integer ``ChunkParams`` plus the loss
    trajectory and the final (dT/dC, dT/dL).
    """
    dev = resolve_device(device)
    bw, rtt_a, throttle_t, throttle_bw = _prep(bandwidth, rtt, None, None,
                                               dev)
    file_f = torch.tensor(float(file_size), dtype=torch.float32, device=dev)
    p_fail = loss_rate + corruption_rate
    if init is None:
        seed_res = autotune_chunk_params(
            bandwidth, rtt, int(file_size), grid=grid, mode=mode,
            pipeline_depth=pipeline_depth,
            loss_rate=loss_rate, corruption_rate=corruption_rate,
            hedge_quantile=hedge_quantile,
            decode_bytes_per_s=decode_bytes_per_s,
            n_seeds=4 if p_fail > 0.0 else 1, device=dev)
        init = (float(seed_res.params.initial_chunk),
                float(seed_res.params.large_chunk))
    l_floor = _l_floor_for(min_chunk, file_size, max_rounds, p_fail)
    cfg = SimConfig(max_rounds=max_rounds, exact_sizes=False,
                    pipeline_depth=pipeline_depth,
                    loss_rate=loss_rate, corruption_rate=corruption_rate,
                    hedge_quantile=hedge_quantile,
                    decode_bytes_per_s=decode_bytes_per_s)
    min_f = torch.tensor(float(min_chunk), dtype=torch.float32, device=dev)

    def total_time(z, bw, rtt_a, throttle_t, throttle_bw):
        c, l = _z_decode(z, min_chunk, l_floor)
        return simulate_scan_core(
            bw[None], rtt_a[None], throttle_t[None], throttle_bw[None], 0,
            ChunkArrays(c, l, min_f), file_f, mode=mode, config=cfg,
        ).total_time[0]

    vg = _value_and_grad(total_time, dev)
    vg_args = (bw, rtt_a, throttle_t, throttle_bw)
    z0 = _z_init(init, min_chunk, l_floor)
    best_z, history = _adam_descend(vg, z0, steps, lr, args=vg_args)
    return _finish_grad_tune(
        vg, vg_args, best_z, history, init, min_chunk, l_floor, mode,
        bw, rtt_a, throttle_t, throttle_bw, file_f, pipeline_depth,
        loss_rate, corruption_rate, hedge_quantile, decode_bytes_per_s)
