"""Online (C, L) tuning from live fleet telemetry.

The offline tuners (``repro.core.autotune``) pick chunk geometry ONCE,
before a transfer starts, from whatever bandwidth estimates are at hand.
MDTP's core claim (§IV-V) is that geometry must *adapt* to observed
conditions — and the paper's throttle / added-latency experiments
(Fig. 6/7) are exactly the cases where a one-shot choice goes stale
mid-transfer.  This module closes the loop: tuners that consume live
:class:`Telemetry` snapshots (per-replica throughput + RTT measurements,
achieved aggregate throughput) and emit fresh ``ChunkParams`` while the
bytes are still flowing.

Three tuners, one ``update(telemetry) -> ChunkParams | None`` contract:

:class:`GridTuner`
    Re-runs the one-shot grid sweep per update — the ``retune``
    workflow packaged as an online policy (simulation-trusting, no
    memory).

:class:`MCGradTuner` / :func:`tune_chunk_params_mcgrad`
    Jitter-smoothed Monte-Carlo gradient descent.  Transfer time is a
    sawtooth in (C, L): smooth within a fixed round count with downward
    jumps where the file packs into one fewer round, so the single-path
    gradient of ``tune_chunk_params_grad`` sees only the within-basin
    slope and is blind to RTT amortization (the macro trend lives in the
    jumps).  Averaging the **pathwise gradient over a lane batch of
    bandwidth/RTT-jitter seeds** randomizes where the jumps fall, so the
    expected loss is a smoothed sawtooth whose slope DOES reflect the
    across-jump trend, one batch of lanes per step, gradients
    included (cf. the hybrid-RL elastic transfer optimizer of
    arXiv:2511.06159, which learns the same signal model-free).

:class:`BanditTuner`
    A discounted-UCB bandit over a small set of (C, L) arms seeded from
    the grid winner.  Unlike the simulators above, its reward is the
    **measured** aggregate throughput of the bytes actually moved under
    each arm — it trusts the fleet, not the model, so it also corrects
    for everything the simulator doesn't capture (server think time,
    client-side scheduling, estimator lag).  Exponential discounting
    (Garivier & Moulines' D-UCB) keeps old rewards from pinning a stale
    arm after conditions change, and an explicit drift detector resets
    all confidence — and re-seeds the arm set from a fresh sweep — when
    observed per-replica bandwidth departs from the scenario the arms
    were planned for (mirror death, throttle, latency step).

Wiring: ``MDTPClient.fetch(..., tuner=...)`` feeds telemetry between
rounds of requests, and ``repro_torch.checkpoint.restore_checkpoint(...,
tuner=...)`` passes a tuner to the blob fetch's in-transfer hook.

The port of ``repro.core.online``.  Each tuner has a ``device`` field
(default the card); on a card its simulations run on a stream of their
own, so a tuner updating in the client's executor thread does not queue
behind a restore's host-to-device copies on the default stream.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from .autotune import (
    GradTuneResult,
    _adam_descend,
    _finish_grad_tune,
    _l_floor_for,
    _value_and_grad,
    _z_init,
    autotune_chunk_params,
)
from .chunking import DEFAULT_MIN_CHUNK, ChunkParams
from .throughput import rtt_corrected_bandwidth
from .torch_alloc import ChunkArrays
from .torch_sim import SimConfig, _prep, simulate_scan_core

__all__ = [
    "Telemetry",
    "rtt_corrected_bandwidth",
    "tune_chunk_params_mcgrad",
    "GridTuner",
    "MCGradTuner",
    "BanditTuner",
]

#: fallback request RTT (s) for replicas that never produced a sample —
#: matches ``MDTPClient.DEFAULT_RTT`` / the FABRIC WAN scenarios.
_DEFAULT_RTT = 0.03


@dataclass(frozen=True)
class Telemetry:
    """One live snapshot of fleet state, as the transfer layer sees it.

    Per-replica vectors are positional and FULL-fleet (dead or unprobed
    replicas keep their slot with a ``<= 0`` value) so tuners can track
    replica identity across updates — drift detection needs to know that
    *replica 3* died, not that the vector shrank.
    """

    #: per-replica observed throughput, bytes/s (``<= 0`` = dead/unprobed).
    bandwidth: tuple[float, ...]
    #: per-replica measured request RTT, seconds (``<= 0`` = no sample).
    rtt: tuple[float, ...]
    #: bytes still to move in the current transfer (the tuning objective:
    #: pick geometry for the *remainder*, not the original file).
    remaining_bytes: float
    #: aggregate bytes/s achieved since the previous update — the
    #: measured reward the bandit credits to the arm that was in play.
    measured_throughput: float = 0.0
    #: seconds since the transfer started (diagnostics / traces).
    elapsed: float = 0.0

    def live(self, default_rtt: float = _DEFAULT_RTT
             ) -> tuple[list[float], list[float]]:
        """(bandwidth, rtt) lists over live replicas only, RTT gaps filled
        with ``default_rtt`` — the shape the simulators expect."""
        bw, rtts = [], []
        for b, r in zip(self.bandwidth, self.rtt):
            if b <= 0.0:
                continue
            bw.append(float(b))
            rtts.append(float(r) if r > 0.0 else default_rtt)
        return bw, rtts

    @classmethod
    def from_report(cls, report, replicas,
                    remaining_bytes: float) -> "Telemetry":
        """Snapshot a completed transfer's ``TransferReport`` — the one
        canonical report→telemetry encoding (failed replica = 0.0 slot,
        positional full-fleet vectors, unmeasured RTT = 0.0), shared by
        the checkpoint-restore wave loop and any other batch consumer.
        ``observed_throughputs`` are already WIRE rates — the client
        strips the per-request RTT bias at the observation point
        (``repro.transfer.client.wire_elapsed``) — so they pass through
        uncorrected here; applying ``rtt_corrected_bandwidth`` again
        would overstate capacity.  Duck-typed to avoid a core→transfer
        import."""
        bandwidth = []
        for r in replicas:
            if r.name in report.failed_replicas:
                bandwidth.append(0.0)
                continue
            bandwidth.append(float(
                report.observed_throughputs.get(r.name, 0.0)))
        return cls(
            bandwidth=tuple(bandwidth),
            rtt=tuple(float(report.observed_rtts.get(r.name, 0.0))
                      for r in replicas),
            remaining_bytes=float(remaining_bytes),
            measured_throughput=report.throughput,
            elapsed=report.elapsed,
        )


# --------------------------------------------------------------------------
# Jitter-smoothed Monte-Carlo gradient tuning
# --------------------------------------------------------------------------

def _side_stream(device: torch.device):
    """A stream of its own for a tuner's simulations on a card, so their
    host syncs wait on nothing else queued on the default stream (a
    restore's leaf copies); a no-op context on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device=device))


def _mc_loss(mode: str, cfg: SimConfig, n_seeds: int):
    """Seed-averaged scan-core loss over ``n_seeds`` lanes.  Without a
    compile step there is nothing to cache, so it is built per call."""

    def mc_loss(z, bw, rtt_a, throttle_t, throttle_bw, file_f,
                min_chunk_f, l_floor_f):
        c = min_chunk_f + torch.exp(z[0])
        l = l_floor_f + torch.exp(z[1])
        k = max(n_seeds, 1)
        seeds = torch.arange(k, device=bw.device)

        def lanes(x):
            return x[None].expand(k, x.shape[-1])

        return simulate_scan_core(
            lanes(bw), lanes(rtt_a), lanes(throttle_t), lanes(throttle_bw),
            seeds, ChunkArrays(c, l, min_chunk_f), file_f,
            mode=mode, config=cfg,
        ).total_time.mean()

    return mc_loss


def tune_chunk_params_mcgrad(
    bandwidth: Sequence[float],
    rtt,
    file_size: int,
    init: tuple[float, float] | None = None,
    steps: int = 40,
    lr: float = 0.08,
    n_seeds: int = 8,
    bw_jitter: float = 0.08,
    rtt_jitter: float = 0.25,
    mode: str = "proportional",
    min_chunk: int = DEFAULT_MIN_CHUNK,
    max_rounds: int = 1024,
    grid: Sequence[tuple[int, int]] | None = None,
    pipeline_depth: int = 1,
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    hedge_quantile: float = 0.0,
    decode_bytes_per_s: float = 0.0,
    device: Optional[Union[str, torch.device]] = None,
) -> GradTuneResult:
    """Monte-Carlo (C, L) descent on the scan core: ``n_seeds`` lanes, their
    pathwise gradients averaged per step.

    ``loss_rate`` / ``corruption_rate`` are the fleet's observed per-chunk
    fault probabilities (``SimConfig`` fault axes): faulted chunks burn
    their duration and are re-fetched, a tax that grows with L — the MC
    seed batch already averages over the fault draws, so the smoothed
    gradient prices it in.

    Each seed draws per-chunk lognormal bandwidth jitter (``bw_jitter``)
    and a per-simulation lognormal RTT scale (``rtt_jitter``), so the
    round-count jump positions differ across the batch and the averaged
    loss surface is a smoothed sawtooth — its gradient sees the RTT
    amortization trend that a single deterministic path reports as zero.
    The descent machinery (floor+exp z-space, Adam, best-seen tracking,
    exact-metric never-worse-than-init guarantee) is shared with
    :func:`repro_torch.core.autotune.tune_chunk_params_grad`; only the
    loss differs.  The reported ``predicted_time`` is the *deterministic*
    exact-sizes round-core time of the adopted integer params.
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
                    jitter=bw_jitter, rtt_jitter=rtt_jitter,
                    pipeline_depth=pipeline_depth,
                    loss_rate=loss_rate, corruption_rate=corruption_rate,
                    hedge_quantile=hedge_quantile,
                    decode_bytes_per_s=decode_bytes_per_s)
    vg = _value_and_grad(_mc_loss(mode, cfg, n_seeds), dev)

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    vg_args = (bw, rtt_a, throttle_t, throttle_bw, file_f,
               f32(min_chunk), f32(l_floor))
    z0 = _z_init(init, min_chunk, l_floor)
    best_z, history = _adam_descend(vg, z0, steps, lr, args=vg_args)
    return _finish_grad_tune(
        vg, vg_args, best_z, history, init, min_chunk, l_floor, mode,
        bw, rtt_a, throttle_t, throttle_bw, file_f, pipeline_depth,
        loss_rate, corruption_rate, hedge_quantile, decode_bytes_per_s)


# --------------------------------------------------------------------------
# Online tuner policies
# --------------------------------------------------------------------------

@dataclass
class GridTuner:
    """Re-run the one-shot grid sweep on every update.

    The simplest online policy: trust the simulator, re-plan from the
    latest measurements.  Stateless beyond the adopted params; the
    baseline the smarter tuners must beat.
    """

    mode: str = "proportional"
    grid: Optional[list[tuple[int, int]]] = None
    default_rtt: float = _DEFAULT_RTT
    #: request pipeline depth of the runtime being tuned — keeps the
    #: simulated RTT amortization honest (``SimConfig.pipeline_depth``).
    pipeline_depth: int = 1
    #: observed per-chunk fault probabilities of the fleet being tuned
    #: (``SimConfig.loss_rate`` / ``corruption_rate``) — re-fetch tax.
    loss_rate: float = 0.0
    corruption_rate: float = 0.0
    #: endgame hedging quantile of the client being tuned
    #: (``SimConfig.hedge_quantile``) — hedging trims the straggler tail
    #: the simulator would otherwise charge to large L.
    hedge_quantile: float = 0.0
    #: client-side decode rate for transfer-encoded bodies
    #: (``SimConfig.decode_bytes_per_s``) — the per-chunk compute tax the
    #: compressed-range path pays; 0 = identity encoding.
    decode_bytes_per_s: float = 0.0
    #: where the tuner's simulations run (None = the card; "cpu" for the
    #: plain host path)
    device: Optional[Union[str, torch.device]] = None
    params: Optional[ChunkParams] = None
    updates: int = 0

    def reset(self) -> None:
        self.params, self.updates = None, 0

    def update(self, t: Telemetry) -> Optional[ChunkParams]:
        bw, rtts = t.live(self.default_rtt)
        if not bw or t.remaining_bytes < 2 * DEFAULT_MIN_CHUNK:
            return None
        self.updates += 1
        p_fail = self.loss_rate + self.corruption_rate
        dev = resolve_device(self.device)
        with _side_stream(dev):
            res = autotune_chunk_params(
                bw, rtts, int(t.remaining_bytes), grid=self.grid,
                mode=self.mode, pipeline_depth=self.pipeline_depth,
                loss_rate=self.loss_rate,
                corruption_rate=self.corruption_rate,
                hedge_quantile=self.hedge_quantile,
                decode_bytes_per_s=self.decode_bytes_per_s,
                n_seeds=4 if p_fail > 0.0 else 1, device=dev)
        self.params = res.params
        return res.params


@dataclass
class MCGradTuner:
    """Online wrapper around :func:`tune_chunk_params_mcgrad`.

    Warm-starts each descent from the previously adopted params (the
    basin rarely teleports between updates), falling back to an implicit
    grid seed on the first call or after :meth:`reset`.
    """

    steps: int = 25
    lr: float = 0.08
    n_seeds: int = 8
    bw_jitter: float = 0.08
    rtt_jitter: float = 0.25
    mode: str = "proportional"
    min_chunk: int = DEFAULT_MIN_CHUNK
    max_rounds: int = 1024
    default_rtt: float = _DEFAULT_RTT
    grid: Optional[list[tuple[int, int]]] = None
    #: request pipeline depth of the runtime being tuned (see GridTuner).
    pipeline_depth: int = 1
    #: observed per-chunk fault probabilities (see GridTuner).
    loss_rate: float = 0.0
    corruption_rate: float = 0.0
    #: endgame hedging quantile of the client being tuned (see GridTuner).
    hedge_quantile: float = 0.0
    #: client-side decode rate for encoded bodies (see GridTuner).
    decode_bytes_per_s: float = 0.0
    #: where the tuner's simulations run (None = the card; "cpu" for the
    #: plain host path)
    device: Optional[Union[str, torch.device]] = None
    params: Optional[ChunkParams] = None
    updates: int = 0
    last_result: Optional[GradTuneResult] = None

    def reset(self) -> None:
        self.params, self.updates, self.last_result = None, 0, None

    def update(self, t: Telemetry) -> Optional[ChunkParams]:
        bw, rtts = t.live(self.default_rtt)
        if not bw or t.remaining_bytes < 2 * self.min_chunk:
            return None
        self.updates += 1
        init = None
        if self.params is not None:
            init = (float(self.params.initial_chunk),
                    float(self.params.large_chunk))
        dev = resolve_device(self.device)
        with _side_stream(dev):
            res = tune_chunk_params_mcgrad(
                bw, rtts, int(t.remaining_bytes), init=init,
                steps=self.steps, lr=self.lr, n_seeds=self.n_seeds,
                bw_jitter=self.bw_jitter, rtt_jitter=self.rtt_jitter,
                mode=self.mode, min_chunk=self.min_chunk,
                max_rounds=self.max_rounds, grid=self.grid,
                pipeline_depth=self.pipeline_depth,
                loss_rate=self.loss_rate,
                corruption_rate=self.corruption_rate,
                hedge_quantile=self.hedge_quantile,
                decode_bytes_per_s=self.decode_bytes_per_s, device=dev)
        self.params, self.last_result = res.params, res
        return res.params


@dataclass
class _Arm:
    params: ChunkParams
    n: float = 0.0      # discounted play count
    s: float = 0.0      # discounted reward sum

    @property
    def mean(self) -> float:
        return self.s / self.n if self.n > 0.0 else 0.0


@dataclass
class BanditTuner:
    """Discounted-UCB bandit over (C, L) arms, rewarded by measured
    throughput.

    Arms are the ``n_arms`` best grid points of a sweep run against
    the telemetry at seeding time (the grid winner plus its strongest
    rivals — the simulator proposes, the fleet disposes).  Each update:

    1. credit ``measured_throughput / sum(live bandwidth)`` (utilization,
       clipped to [0, 2]) to the arm that was in play, after discounting
       every arm's statistics by ``gamma`` — old evidence decays, so the
       bandit stays plastic;
    2. check drift: any live replica whose observed bandwidth or measured
       RTT moved more than ``drift_threshold`` (relative) from the
       seeding scenario — or a replica dying/appearing — re-seeds the
       arms from a fresh sweep and zeroes all confidence (the paper's
       throttle/latency-step events invalidate every reward collected
       under the old regime);
    3. play the arm maximizing ``mean + explore * sqrt(log(N) / n)``
       (unplayed arms first, in predicted-time order).
    """

    n_arms: int = 6
    gamma: float = 0.85
    explore: float = 0.4
    drift_threshold: float = 0.6
    mode: str = "proportional"
    grid: Optional[list[tuple[int, int]]] = None
    default_rtt: float = _DEFAULT_RTT
    #: request pipeline depth of the runtime being tuned (see GridTuner) —
    #: shapes the seeding sweep that proposes the arm set.
    pipeline_depth: int = 1
    #: observed per-chunk fault probabilities (see GridTuner) — shape the
    #: seeding sweep; the measured-throughput reward already prices in
    #: real re-fetch waste without them, so they only affect proposals.
    loss_rate: float = 0.0
    corruption_rate: float = 0.0
    #: endgame hedging quantile of the client being tuned (see GridTuner)
    #: — shapes the seeding sweep's straggler-tail model.
    hedge_quantile: float = 0.0
    #: client-side decode rate for encoded bodies (see GridTuner) —
    #: shapes the seeding sweep; the measured-throughput reward already
    #: prices real decode stalls in.
    decode_bytes_per_s: float = 0.0
    #: where the tuner's simulations run (None = the card; "cpu" for the
    #: plain host path)
    device: Optional[Union[str, torch.device]] = None
    arms: list[_Arm] = field(default_factory=list)
    params: Optional[ChunkParams] = None
    updates: int = 0
    drift_resets: int = 0
    _current: Optional[int] = None
    _seed_bw: Optional[tuple[float, ...]] = None
    _seed_rtt: Optional[tuple[float, ...]] = None

    def reset(self) -> None:
        self.arms, self.params, self._current = [], None, None
        self._seed_bw = self._seed_rtt = None
        self.updates = self.drift_resets = 0

    def _seed_arms(self, t: Telemetry) -> Optional[ChunkParams]:
        bw, rtts = t.live(self.default_rtt)
        if not bw or t.remaining_bytes < 2 * DEFAULT_MIN_CHUNK:
            return None
        p_fail = self.loss_rate + self.corruption_rate
        dev = resolve_device(self.device)
        with _side_stream(dev):
            res = autotune_chunk_params(
                bw, rtts, int(t.remaining_bytes), grid=self.grid,
                mode=self.mode, pipeline_depth=self.pipeline_depth,
                loss_rate=self.loss_rate,
                corruption_rate=self.corruption_rate,
                hedge_quantile=self.hedge_quantile,
                decode_bytes_per_s=self.decode_bytes_per_s,
                n_seeds=4 if p_fail > 0.0 else 1, device=dev)
        order = np.argsort(res.predicted_times)
        self.arms = []
        seen = set()
        for k in order:
            c, l = res.grid[int(k)]
            if (c, l) in seen:
                continue
            seen.add((c, l))
            self.arms.append(_Arm(ChunkParams(c, l, mode=self.mode)))
            if len(self.arms) >= self.n_arms:
                break
        self._seed_bw = tuple(t.bandwidth)
        self._seed_rtt = tuple(t.rtt)
        self._current = 0
        self.params = self.arms[0].params
        return self.params

    def _drifted(self, t: Telemetry) -> bool:
        ref_bw, ref_rtt = self._seed_bw, self._seed_rtt
        if ref_bw is None:
            return False
        now_bw, now_rtt = tuple(t.bandwidth), tuple(t.rtt)
        if len(now_bw) != len(ref_bw):
            return True
        log_thresh = math.log1p(self.drift_threshold)
        for b0, b1 in zip(ref_bw, now_bw):
            alive0, alive1 = b0 > 0.0, b1 > 0.0
            if alive0 != alive1:
                return True                      # death or resurrection
            if alive0 and abs(math.log(b1 / b0)) > log_thresh:
                return True
        for r0, r1 in zip(ref_rtt, now_rtt):
            # a latency step (paper §VII-C) invalidates rewards exactly
            # like a throttle does; unmeasured RTTs (<= 0) are skipped
            if r0 > 0.0 and r1 > 0.0 and abs(math.log(r1 / r0)) > log_thresh:
                return True
        return False

    def update(self, t: Telemetry) -> Optional[ChunkParams]:
        self.updates += 1
        if not self.arms:
            return self._seed_arms(t)

        # 1) credit the measured reward to the arm that produced it
        if t.measured_throughput > 0.0 and self._current is not None:
            live_sum = sum(b for b in t.bandwidth if b > 0.0)
            reward = min(t.measured_throughput / max(live_sum, 1e-9), 2.0)
            for arm in self.arms:
                arm.n *= self.gamma
                arm.s *= self.gamma
            played = self.arms[self._current]
            played.n += 1.0
            played.s += reward

        # 2) fleet left the scenario the arms were planned for → replan
        if self._drifted(t):
            self.drift_resets += 1
            seeded = self._seed_arms(t)
            if seeded is not None:
                return seeded
            # nothing live to re-plan from: keep playing the old arms

        # 3) discounted UCB selection
        unplayed = [i for i, a in enumerate(self.arms) if a.n <= 1e-9]
        if unplayed:
            self._current = unplayed[0]      # predicted-time order
        else:
            total = sum(a.n for a in self.arms)
            log_n = math.log(max(total, math.e))
            self._current = max(
                range(len(self.arms)),
                key=lambda i: (self.arms[i].mean
                               + self.explore
                               * math.sqrt(log_n / self.arms[i].n)))
        self.params = self.arms[self._current].params
        return self.params
