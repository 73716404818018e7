"""Calibrated simulation scenarios for reproducing the paper's experiments.

The paper's FABRIC testbed: one client, six same-spec geographically
distributed servers behind 10 Gbps NICs, Apache over HTTP.  Measured
end-to-end application throughput was far below NIC line rate (Python
client; WAN paths): MDTP moved 64 GB in ~446 s => ~145 MB/s aggregate.

Two presets capture the paper's (mutually tension-y) observations:

* ``paper_baseline`` — one distinctly fast path plus five slower ones,
  aggregate ~145 MB/s.  Reproduces Fig. 2 absolute times, the Fig. 4
  throttling deltas (throttling the fastest to 500 Mbps = 62.5 MB/s must
  actually bite, so the fastest exceeds that), the Fig. 5a/5b utilization
  and packet-skew behavior of Aria2.
* ``paper_balanced`` — six near-equal servers (same aggregate).  Reproduces
  Fig. 5c: with near-homogeneous capacity MDTP issues an *equal number* of
  requests per replica (the paper measured exactly 37 for a 32 GB file),
  because every round completes in lockstep.

Calibration notes live in EXPERIMENTS.md §Reproduction.

This is the port's own copy of ``repro.core.scenarios``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .simulator import ServerSpec

__all__ = [
    "MBPS",
    "GB",
    "paper_baseline",
    "paper_balanced",
    "bittorrent_seeders",
    "with_added_latency",
    "with_throttled_fastest",
    "PAPER_FILE_SIZES",
    "shared_bottleneck",
    "with_fair_share",
    "contention_matrix",
    "ContentionTrace",
    "contention_traces",
    "with_faults",
    "FaultTrace",
    "fault_traces",
    "with_gray_degradation",
    "FlashCrowdTrace",
    "flash_crowd_traces",
    "SwarmTrace",
    "swarm_fleet",
    "swarm_axes",
    "swarm_traces",
    "ShardTrace",
    "shard_fleet",
    "shard_traces",
]

MBPS = 1024 * 1024  # we quote server rates in MiB/s
GB = 1024**3

#: File sizes evaluated in the paper (§VI-A).
PAPER_FILE_SIZES = tuple(s * GB for s in (1, 2, 4, 8, 16, 32, 64))

_DEFAULT_RTT = 0.03  # ~WAN RTT between FABRIC sites


def paper_baseline(rtt: float = _DEFAULT_RTT, jitter: float = 0.02) -> list[ServerSpec]:
    """Six replicas, one fast path: aggregate ~145 MiB/s."""
    rates = [12, 14, 15, 16, 18, 70]
    return [
        ServerSpec(name=f"replica{i + 1}", bandwidth=r * MBPS, rtt=rtt, jitter=jitter)
        for i, r in enumerate(rates)
    ]


def paper_balanced(rtt: float = _DEFAULT_RTT, jitter: float = 0.02) -> list[ServerSpec]:
    """Six near-equal replicas: aggregate ~145.5 MiB/s (Fig. 5c regime)."""
    rates = [23.0, 23.5, 24.0, 24.5, 25.0, 25.5]
    return [
        ServerSpec(name=f"replica{i + 1}", bandwidth=r * MBPS, rtt=rtt, jitter=jitter)
        for i, r in enumerate(rates)
    ]


def bittorrent_seeders(
    rtt: float = _DEFAULT_RTT,
    mean_up: float = 60.0,
    mean_down: float = 45.0,
) -> list[ServerSpec]:
    """The same six replicas as seeders with on/off availability flapping.

    Calibrated so the expected number of simultaneously active seeders sits
    in the paper's observed 2-5 band (Fig. 2c): availability = up/(up+down)
    = 0.57 => E[active] ~= 3.4 of 6.
    """
    return [
        ServerSpec(
            name=s.name, bandwidth=s.bandwidth, rtt=rtt, jitter=s.jitter,
            avail_up=mean_up, avail_down=mean_down,
        )
        for s in paper_baseline(rtt=rtt)
    ]


def with_added_latency(
    servers: list[ServerSpec], extra_rtt: float = 0.5
) -> list[ServerSpec]:
    """Paper §VII-C: +0.5 s latency on the *fastest* server's requests."""
    fastest = max(range(len(servers)), key=lambda i: servers[i].bandwidth)
    return [
        replace(s, rtt=s.rtt + extra_rtt) if i == fastest else s
        for i, s in enumerate(servers)
    ]


# --------------------------------------------------------------------------
# Multi-transfer contention (fleet-shared scheduling, TransferManager)
# --------------------------------------------------------------------------
#
# MDTP's bin-packing frames each server as a capacity bin for ONE transfer
# (§IV).  A managed fleet packs K concurrent transfers into the same bins;
# the simulator-side mirror models contention as a fair k-way bandwidth
# split per replica (TCP-fair sharing of each mirror's uplink), which is
# what ``repro_torch.core.autotune.contention_sweep`` vmaps over and what
# ``benchmarks/contention_bench.py`` replays phase by phase.


def shared_bottleneck(rtt: float = _DEFAULT_RTT,
                      jitter: float = 0.0) -> list[ServerSpec]:
    """Six replicas where ONE fast path carries most of the fleet:
    aggregate ~140 MiB/s, 120 of it behind a single mirror.  Concurrent
    transfers all lean on the same bottleneck — the worst case for
    independent greedy clients that each plan as if they owned it."""
    rates = [4, 4, 4, 4, 4, 120]
    return [
        ServerSpec(name=f"replica{i + 1}", bandwidth=r * MBPS, rtt=rtt,
                   jitter=jitter)
        for i, r in enumerate(rates)
    ]


def with_fair_share(servers: list[ServerSpec], k: int) -> list[ServerSpec]:
    """The fleet as ONE of ``k`` concurrent transfers sees it: every
    mirror's bandwidth (and throttle-profile rates) split ``k`` ways.
    ``k = 1`` returns the servers unchanged."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if k == 1:
        return list(servers)
    return [
        replace(s, bandwidth=s.bandwidth / k,
                profile=tuple((t, bw / k) for t, bw in s.profile))
        for s in servers
    ]


def contention_matrix(servers: list[ServerSpec],
                      ks: list[int]) -> list[list[float]]:
    """``[len(ks), N]`` per-transfer bandwidth rows (row i = fair share
    under ``ks[i]`` concurrent transfers) — the scenario-batch input for
    ``sweep_scenarios`` / ``contention_sweep``."""
    return [[s.bandwidth / k for s in servers] for k in ks]


@dataclass(frozen=True)
class ContentionTrace:
    """K transfers contending for one fleet.

    ``sizes[j]`` bytes for transfer j, arriving ``arrivals[j]`` seconds
    after trace start.  Replayed phase-by-phase (a phase = a constant
    active set, each active transfer at fair share) by the contention
    benchmark and the manager tests.
    """

    name: str
    servers: tuple[ServerSpec, ...]
    sizes: tuple[int, ...]
    arrivals: tuple[float, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.arrivals):
            raise ValueError("one arrival per transfer required")


def contention_traces() -> list[ContentionTrace]:
    """The three fleet-contention regimes the manager must win:

    * ``simultaneous`` — three unequal transfers arrive together on the
      calibrated baseline fleet (pure k-way split; k drops 3 → 2 → 1 as
      the shorter transfers drain, re-expanding everyone's share);
    * ``staggered`` — transfers land 5 s apart, flipping the fleet
      through the k = 1/2/3 regimes in both directions;
    * ``bottleneck`` — K=3 transfers leaning on one dominant path, where
      greedy per-transfer planning oversizes the shared bin the most.

    WAN-grade RTTs (the FABRIC inter-site regime, amplified) make chunk
    geometry matter: at a fair k-way share the RTT-amortization optimum
    shifts, which is exactly the signal ``contention_sweep`` captures.
    Deterministic (``jitter=0``) so benchmark comparisons are exact.
    """
    base = tuple(paper_baseline(rtt=0.20, jitter=0.0))
    bottleneck = tuple(shared_bottleneck(rtt=0.30))
    return [
        ContentionTrace(
            "simultaneous", base,
            sizes=(GB, 3 * GB // 4, GB // 2),
            arrivals=(0.0, 0.0, 0.0)),
        ContentionTrace(
            "staggered", base,
            sizes=(GB, GB, GB),
            arrivals=(0.0, 5.0, 10.0)),
        ContentionTrace(
            "bottleneck", bottleneck,
            sizes=(GB, GB, GB),
            arrivals=(0.0, 0.0, 0.0)),
    ]


def with_gray_degradation(
    servers: list[ServerSpec],
    degrade_at: float,
    degrade_factor: float = 0.1,
    only: int | None = None,
) -> list[ServerSpec]:
    """Inject silent mid-transfer degradation (``ServerSpec.degrade_at``/
    ``degrade_factor``) — the paper's "bandwidth decrease to the fastest
    server" case.  ``only=None`` grays the whole fleet; ``only=i`` grays
    just replica ``i`` (one slow mirror, the hedging/probation regime)."""
    return [
        replace(s, degrade_at=degrade_at, degrade_factor=degrade_factor)
        if only is None or i == only else s
        for i, s in enumerate(servers)
    ]


@dataclass(frozen=True)
class FlashCrowdTrace:
    """One named overload regime: a fleet plus an arrival process.

    ``sizes[j]`` bytes arrive at ``arrivals[j]`` seconds — the workload
    the manager's admission gate, SRPT queue, and shed mode absorb.
    Deterministic arrival times (no RNG) so benchmark replays and the
    simulator agree on the exact storm shape.
    """

    name: str
    servers: tuple[ServerSpec, ...]
    sizes: tuple[int, ...]
    arrivals: tuple[float, ...]


def flash_crowd_traces(rtt: float = _DEFAULT_RTT) -> list[FlashCrowdTrace]:
    """The three overload regimes of the ROADMAP's flash-crowd item:

    * ``burst`` — a flash crowd: 12 same-sized transfers land within
      ~0.6 s of each other on the calibrated baseline fleet.  Without
      admission control everyone splits every mirror 12 ways and every
      transfer finishes late together; with SRPT + a max-active gate the
      short head of the queue drains fast.
    * ``diurnal`` — two arrival waves (morning/evening) of 6 transfers
      each with mixed sizes; exercises queue drain + re-expansion.
    * ``gray-burst`` — the ``burst`` storm while the FASTEST mirror
      silently degrades to 10% of its bandwidth mid-storm
      (``ServerSpec.degrade_at``): the compound case hedged endgame +
      probation + admission are jointly built for.

    Deterministic fleets (``jitter=0``) and arrival grids, so real-socket
    replays (``benchmarks/flashcrowd_bench.py``) and simulator runs see
    the identical storm.
    """
    base = tuple(paper_baseline(rtt=rtt, jitter=0.0))
    fastest = max(range(len(base)), key=lambda i: base[i].bandwidth)
    burst_arrivals = tuple(0.05 * j for j in range(12))
    wave = tuple(0.2 * j for j in range(6))
    diurnal_arrivals = wave + tuple(30.0 + t for t in wave)
    return [
        FlashCrowdTrace(
            "burst", base,
            sizes=(GB // 4,) * 12,
            arrivals=burst_arrivals),
        FlashCrowdTrace(
            "diurnal", base,
            sizes=(GB // 4, GB // 2, GB // 8, GB // 4, GB // 2, GB // 8) * 2,
            arrivals=diurnal_arrivals),
        FlashCrowdTrace(
            "gray-burst",
            tuple(with_gray_degradation(
                list(base), degrade_at=2.0, degrade_factor=0.1,
                only=fastest)),
            sizes=(GB // 4,) * 12,
            arrivals=burst_arrivals),
    ]


# --------------------------------------------------------------------------
# Fault injection (integrity + loss — the chaos-harness mirror)
# --------------------------------------------------------------------------
#
# The real stack injects faults at the HTTP server (``transfer.server
# .FaultPolicy``) and recovers in the client (CRC verify, banned re-pool,
# resume journal).  These traces are the simulator-side mirror: the same
# per-chunk loss/corruption probabilities on ``ServerSpec``, with matching
# ``SimConfig.loss_rate``/``corruption_rate`` for the on-device tuner
# cores, so (C, L) tuning can price in re-fetch overhead.


def with_faults(
    servers: list[ServerSpec],
    loss_rate: float = 0.0,
    corruption_rate: float = 0.0,
    only: int | None = None,
) -> list[ServerSpec]:
    """Inject per-chunk fault probabilities into a fleet.

    ``only=None`` applies the rates to every replica (a lossy client-side
    path); ``only=i`` taints just replica ``i`` (one bad mirror — the
    regime where re-fetch-from-alternate wins big).
    """
    return [
        replace(s, loss_rate=loss_rate, corruption_rate=corruption_rate)
        if only is None or i == only else s
        for i, s in enumerate(servers)
    ]


@dataclass(frozen=True)
class FaultTrace:
    """One named fault regime, with the fleet-wide effective rates the
    on-device tuner cores should mirror (``SimConfig.loss_rate`` /
    ``corruption_rate`` are scalar, so per-replica taints are averaged
    into an effective fleet rate weighted by nothing fancier than 1/N —
    the tuner only needs the right order of magnitude of re-fetch tax)."""

    name: str
    servers: tuple[ServerSpec, ...]
    loss_rate: float
    corruption_rate: float


def fault_traces(rtt: float = _DEFAULT_RTT) -> list[FaultTrace]:
    """The three fault regimes the robustness suite exercises:

    * ``lossy-path`` — every replica drops 5% of chunks mid-body (WAN
      resets); tests reclaim + backoff overhead.
    * ``corrupt-mirror`` — ONE replica (the fastest, worst case) corrupts
      20% of its bodies; tests CRC verify + banned re-pool + the fleet
      health deprioritization.
    * ``flaky-fleet`` — 2% loss and 2% corruption everywhere; the
      background-noise regime (C, L) tuning should price in.

    Deterministic base fleets (``jitter=0``) so fault overhead is the
    only stochastic term.
    """
    base = paper_baseline(rtt=rtt, jitter=0.0)
    fastest = max(range(len(base)), key=lambda i: base[i].bandwidth)
    n = len(base)
    return [
        FaultTrace(
            "lossy-path",
            tuple(with_faults(base, loss_rate=0.05)),
            loss_rate=0.05, corruption_rate=0.0),
        FaultTrace(
            "corrupt-mirror",
            tuple(with_faults(base, corruption_rate=0.20, only=fastest)),
            loss_rate=0.0, corruption_rate=0.20 / n),
        FaultTrace(
            "flaky-fleet",
            tuple(with_faults(base, loss_rate=0.02, corruption_rate=0.02)),
            loss_rate=0.02, corruption_rate=0.02),
    ]


def with_throttled_fastest(
    servers: list[ServerSpec],
    limit_bytes_per_s: float = 62.5 * 1000 * 1000,  # 500 Mbps
    at_time: float = 0.0,
) -> list[ServerSpec]:
    """Paper §VII-D: cap the fastest server's bandwidth at 500 Mbps."""
    fastest = max(range(len(servers)), key=lambda i: servers[i].bandwidth)
    out = []
    for i, s in enumerate(servers):
        if i == fastest:
            capped = min(s.bandwidth, limit_bytes_per_s)
            out.append(replace(s, profile=s.profile + ((at_time, capped),)))
        else:
            out.append(s)
    return out


# --------------------------------------------------------------------------
# Peer-assisted broadcast (checkpoint-restore swarms)
# --------------------------------------------------------------------------
#
# The real stack: N restoring nodes arrive together, each mounting its
# filling buffer on a ``repro.transfer.PeerMirror`` and fetching from the
# origin plus every other restorer's mirror (coverage-gated packing).
# The simulator mirror below is the capacity view ONE such restorer sees:
# the origin at a fair 1/n share of its fixed uplink, and each peer as a
# mirror that starts DARK (a restoring node has nothing to serve yet) and
# steps UP to a fair share of its uplink at a staggered onset — the
# inverse of the Fig. 4 down-throttle, riding the same single-breakpoint
# (bw0, throttle_t, bw1) axes of the jax round/scan cores.

#: effectively-offline rate for a peer that hasn't come online yet: low
#: enough to contribute nothing, high enough that its probe chunk's
#: pre-onset crawl doesn't dominate a round (the onset step completes it).
_DARK_BW = 1.0


def swarm_fleet(n: int, origin_bw: float = 96 * MBPS,
                peer_bw: float | None = None, onset: float = 1.0,
                rtt: float = _DEFAULT_RTT) -> list[ServerSpec]:
    """The fleet ONE of ``n`` broadcast restorers sees.

    ``origin_bw`` is the origin's FIXED aggregate capacity — n restorers
    arriving together split it n ways (TCP-fair), so the per-client
    origin share shrinks as the swarm grows; that scarcity is exactly
    what peer serving relieves.  Each of the other ``n - 1`` restorers
    appears as a peer mirror: dark until ``onset`` scaled by a per-peer
    stagger (ranges complete one restorer at a time, so peers come
    online spread over [onset, 2*onset)), then serving a fair
    ``1/(n - 1)`` share of its own uplink (``peer_bw``, default =
    ``origin_bw``).  ``n = 1`` is the no-swarm baseline: the origin
    alone at full rate.
    """
    if n < 1:
        raise ValueError(f"swarm size must be >= 1, got {n}")
    peer_bw = origin_bw if peer_bw is None else peer_bw
    servers = [ServerSpec(name="origin", bandwidth=origin_bw / n, rtt=rtt,
                          jitter=0.0)]
    for k in range(n - 1):
        stagger = onset * (1.0 + k / max(n - 1, 1))
        servers.append(ServerSpec(
            name=f"peer{k + 1}", bandwidth=_DARK_BW, rtt=rtt, jitter=0.0,
            profile=((stagger, peer_bw / (n - 1)),)))
    return servers


def swarm_axes(servers: list[ServerSpec]) -> tuple[list, list, list]:
    """``(bw0, throttle_t, throttle_bw)`` per-server axes for the jax
    round/scan cores (their single-breakpoint throttle form).  Servers
    without a profile keep their rate on both sides of an infinite
    breakpoint; profiled servers contribute their first step — which for
    a swarm peer is the UP-step onset."""
    bw0, tt, tb = [], [], []
    for s in servers:
        bw0.append(float(s.bandwidth))
        if s.profile:
            t, b = s.profile[0]
            tt.append(float(t))
            tb.append(float(b))
        else:
            tt.append(float("inf"))
            tb.append(float(s.bandwidth))
    return bw0, tt, tb


@dataclass(frozen=True)
class SwarmTrace:
    """One named broadcast regime: ``n`` restorers of a ``size``-byte
    checkpoint on one fixed-capacity origin, as the per-client fleet
    view of :func:`swarm_fleet`.  Deterministic (``jitter=0``) so the
    event core and the round/scan cores (via :func:`swarm_axes`) replay
    the identical capacity schedule."""

    name: str
    n: int
    servers: tuple[ServerSpec, ...]
    size: int


def swarm_traces(rtt: float = _DEFAULT_RTT) -> list[SwarmTrace]:
    """The three broadcast regimes the swarm suite exercises:

    * ``pair`` — 2 restorers: the minimal swarm (one peer each); mostly
      a sanity anchor, peer capacity equals origin capacity.
    * ``quad`` — 4 restorers arriving together, early peer onset: the
      real-socket benchmark's shape (``benchmarks/broadcast_bench.py``
      runs this with actual ``PeerMirror`` fleets).
    * ``cold-start`` — 8 restorers behind a LATE onset: the origin-bound
      opening phase dominates, the regime where striped first-fetches
      (de-correlating what each node asks the origin for) matter most.
    """
    return [
        SwarmTrace("pair", 2,
                   tuple(swarm_fleet(2, onset=0.5, rtt=rtt)), GB),
        SwarmTrace("quad", 4,
                   tuple(swarm_fleet(4, onset=0.5, rtt=rtt)), GB),
        SwarmTrace("cold-start", 8,
                   tuple(swarm_fleet(8, onset=4.0, rtt=rtt)), GB),
    ]


# --------------------------------------------------------------------------
# Sharded, work-stealing restore (K-host meshes)
# --------------------------------------------------------------------------
#
# The real stack (``repro.transfer.shard``): a K-host mesh splits the
# blob into contiguous per-host spans; each host fetches its span from
# its own origin and serves landed bytes to peers, and hosts that finish
# early *steal* uncovered tails of a straggling host's span — fetching
# them through their own fast origin so the victim can drain the stolen
# range from a fast peer mirror instead of its slow origin.  The
# simulator mirror below is the capacity view the STRAGGLER sees for its
# own span: its slow origin, plus each would-be thief as a peer mirror
# that comes online once the thief has finished its own span and landed
# stolen bytes worth advertising.


def shard_fleet(k: int, origin_bw: float = 96 * MBPS,
                straggler_frac: float = 0.125, steal_onset: float = 1.0,
                rtt: float = _DEFAULT_RTT) -> list[ServerSpec]:
    """The fleet the straggler of a ``k``-host sharded restore sees.

    Its own origin runs at ``origin_bw * straggler_frac`` (the gray
    mirror that motivates stealing); each of the other ``k - 1`` hosts
    appears as a peer that is dark until ``steal_onset`` scaled by a
    per-thief stagger (a thief first finishes its OWN span, then lands
    stolen bytes), then serves a fair ``1/(k - 1)`` share of a full
    ``origin_bw`` uplink.  ``straggler_frac = 1`` is the balanced
    no-straggler baseline.
    """
    if k < 1:
        raise ValueError(f"shard count must be >= 1, got {k}")
    servers = [ServerSpec(name="origin", bandwidth=origin_bw * straggler_frac,
                          rtt=rtt, jitter=0.0)]
    for t in range(k - 1):
        stagger = steal_onset * (1.0 + t / max(k - 1, 1))
        servers.append(ServerSpec(
            name=f"thief{t + 1}", bandwidth=_DARK_BW, rtt=rtt, jitter=0.0,
            profile=((stagger, origin_bw / max(k - 1, 1)),)))
    return servers


@dataclass(frozen=True)
class ShardTrace:
    """One named sharded-restore regime: the straggler's-eye view of a
    ``k``-host mesh restoring a blob whose per-host span is ``size``
    bytes.  Deterministic (``jitter=0``); ``swarm_axes`` converts the
    servers to the jax round/scan throttle form unchanged (peer onsets
    are single up-steps, exactly like swarm peers)."""

    name: str
    k: int
    servers: tuple[ServerSpec, ...]
    size: int


def shard_traces(rtt: float = _DEFAULT_RTT) -> list[ShardTrace]:
    """The two regimes ``benchmarks/shard_bench.py`` mirrors with real
    sockets:

    * ``balanced`` — 4 hosts, no straggler: stealing should find nothing
      to do and cost nothing (the win-guard's "do no harm" side).
    * ``straggler`` — 4 hosts, one origin at 1/8 rate: the regime where
      work stealing converts the victim's makespan from span/slow-rate
      toward span/(slow + thieves' fair shares).
    """
    span = GB // 4
    return [
        ShardTrace("balanced", 4,
                   tuple(shard_fleet(4, straggler_frac=1.0, rtt=rtt)), span),
        ShardTrace("straggler", 4,
                   tuple(shard_fleet(4, straggler_frac=0.125,
                                     steal_onset=0.5, rtt=rtt)), span),
    ]
